"""B streams in lockstep: the port's ``BatchedStreamingSession`` against the JAX
package's on the same doctored tiny weights, and against three single port
``StreamingSession``s that each serve one stream alone.

Three streams (100, 64 and 83 fbank frames) arrive staggered; one ends on a
block boundary, one inside a block (the encoder masks its padding), and one
then rides along in empty blocks. CTC ids must be equal and the encoder rows
within 2e-4; the MT decode under uneven budgets (hold, 2, to EOS) and after a
whole-word rollback of one stream must give equal tokens; the emissions equal
units and durations and the wav within 1e-4.
"""

import numpy as np
import pytest
import torch
from streamspeech_tpu.runtime.batched import BatchedStreamingSession as JaxBatched
from tests.jax_init import shared_jax_init  # noqa: F401
from tests.torch_serving_stack import build_stack
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.models.layers import KVCache, StreamKVCache
from streamspeech_tpu_torch.runtime.batched import BatchedStreamingSession

CHUNK, CONV_CHUNK = 4, 8    # a lockstep block of 4 * lcm(4, 8) = 32 fbank frames
LENGTHS = (100, 64, 83)
# fbank frames handed to each stream in each round (None: nothing); a stream's
# last piece finishes it
ROUNDS = [(40, 20, 35), (30, 44, 20), (None, None, 28), (30, None, None)]


@pytest.fixture(scope="module")
def served():
    """Both packages' batched sessions and the port's singles, fed, decoded,
    rolled back, decoded again and emitted; the intermediate results."""
    stack = build_stack()
    rng = np.random.RandomState(7)
    streams = [rng.randn(n, 80).astype(np.float32) for n in LENGTHS]
    sessions = {"jax": JaxBatched(stack["jax"], 3),
                "port": BatchedStreamingSession(stack["port"], 3)}
    blocks = {k: [] for k in sessions}
    sent = [0, 0, 0]
    for r in ROUNDS:
        for i, n in enumerate(r):
            if n is None:
                continue
            piece = streams[i][sent[i]: sent[i] + n]
            sent[i] += n
            for s in sessions.values():
                s.push_features(i, piece, finished=sent[i] == LENGTHS[i])
        for k, s in sessions.items():
            blocks[k].append(s.encode_ready_blocks(CHUNK, CONV_CHUNK))
    assert sent == list(LENGTHS)
    singles = []
    for feats in streams:
        single = stack["port"].new_session()
        single.push_features(feats, CHUNK, CONV_CHUNK, finished=True)
        singles.append(single)
    out = {"blocks": blocks, "singles": singles, "sessions": sessions,
           "enc": {k: (np.array(s.enc_len), np.asarray(s.enc_buf).copy(),
                       [list(a) for a in s.asr_ids], [list(a) for a in s.st_ids])
                   for k, s in sessions.items()}}
    out["decode1"] = {k: s.mt_decode(np.array([0, 2, -1])) for k, s in sessions.items()}
    for k, s in sessions.items():
        s.mt_truncate(2, 3)
    out["decode2"] = {k: s.mt_decode(np.array([3, 1, 2])) for k, s in sessions.items()}
    # the same decodes and rollback, each stream alone
    out["single_decodes"] = [[list(single.mt_decode(b))] for single, b in zip(singles, (0, 2, -1))]
    singles[2].mt_truncate(3)
    for single, b, decodes in zip(singles, (3, 1, 2), out["single_decodes"]):
        decodes.append(list(single.mt_decode(b)))
    n_prev = [0, 1, 2]
    out["emit_tail"] = {k: s.emit_tail(n_prev) for k, s in sessions.items()}
    out["emit"] = {k: s.emit() for k, s in sessions.items()}
    return out


def test_encoder_blocks_and_ctc_ids_match_jax(served):
    assert served["blocks"]["port"] == served["blocks"]["jax"]
    assert served["blocks"]["port"] == [0, 1, 1, 2]
    (jl, jbuf, jasr, jst), (pl, pbuf, pasr, pst) = (served["enc"]["jax"],
                                                   served["enc"]["port"])
    np.testing.assert_array_equal(pl, jl)
    assert pasr == jasr and pst == jst
    for i, n in enumerate(jl):
        np.testing.assert_allclose(pbuf[i, :n], jbuf[i, :n], rtol=2e-4, atol=2e-4)


def test_encoder_rows_match_single_sessions(served):
    _, pbuf, pasr, pst = served["enc"]["port"]
    for i, single in enumerate(served["singles"]):
        assert served["enc"]["port"][0][i] == single.enc_len
        assert pasr[i] == single.asr_ids and pst[i] == single.st_ids
        np.testing.assert_allclose(pbuf[i, : single.enc_len],
                                   single.enc_buf[0, : single.enc_len].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_uneven_budgets_and_one_stream_rollback_match_jax(served):
    for step in ("decode1", "decode2"):
        assert served[step]["port"] == served[step]["jax"], step
    d1 = served["decode1"]["port"]
    assert d1[0] == [] and len(d1[1]) == 2 and len(d1[2]) > 2, d1
    d2 = served["decode2"]["port"]
    assert d2[1][:2] == d1[1] and d2[2][:3] == d1[2][:3]
    # the second decode's one scan call (3 steps, budgets 3, 1, 2) wrote each
    # row from its own length: the rollback of stream 2 moved its alone
    offsets = np.array([len(d1[0]), len(d1[1]), 3])
    for kv in served["sessions"]["port"].mt_self:
        np.testing.assert_array_equal(kv.index.numpy(), offsets + 2)


def test_decode_matches_single_sessions(served):
    for i, (first, second) in enumerate(served["single_decodes"]):
        assert first == served["decode1"]["port"][i]
        assert second == served["decode2"]["port"][i]


def _same_emissions(got, want, atol):
    for i, ((pu, pw, pd), (ju, jw, jd)) in enumerate(zip(got, want)):
        assert pu == list(ju), i
        np.testing.assert_array_equal(np.asarray(pd), np.asarray(jd), err_msg=str(i))
        assert np.asarray(pw).shape == np.asarray(jw).shape, i
        np.testing.assert_allclose(np.asarray(pw), np.asarray(jw), atol=atol,
                                   err_msg=str(i))


def test_emissions_match_jax(served):
    for kind in ("emit_tail", "emit"):
        _same_emissions(served[kind]["port"], served[kind]["jax"], 1e-4)
    units = [u for u, _, _ in served["emit"]["port"]]
    assert all(len(u) > 0 for u in units[1:]), units    # non-vacuous


def test_emissions_match_single_sessions(served):
    singles = served["singles"]
    for i, n_prev in enumerate((0, 1, 2)):
        _same_emissions([served["emit_tail"]["port"][i]], [singles[i].emit_tail(n_prev)],
                        1e-5)
        _same_emissions([served["emit"]["port"][i]], [singles[i].emit()], 1e-5)


class _ScriptedDecoder(torch.nn.Module):
    """Stands in for the MT decoder: at its n-th ``step`` row b predicts
    script[b][n] (one-hot logits), whatever it is fed."""

    def __init__(self, script, vocab):
        super().__init__()
        self.script, self.vocab, self.calls = script, vocab, 0
        self.embed_tokens = torch.zeros((vocab, 1))

    def step(self, tokens, offset, self_caches, cross_caches, cross_valid=None):
        nxt = torch.tensor([row[self.calls] for row in self.script])
        self.calls += 1
        return torch.nn.functional.one_hot(nxt, self.vocab).float()[:, None], None


@pytest.mark.parametrize("budget,emitted,hit_eos", [
    (2, 2, False),     # EOS at the third step, past the budget: not reported
    (3, 2, True),      # within the budget
    (0, 0, False),     # a held stream
])
def test_scan_reports_no_eos_past_the_budget(served, budget, emitted, hit_eos):
    """ROADMAP §C: JAX's scan also reports an EOS that a step past the budget
    predicted (`models/streamspeech.py:228,237`); the port's does not. PAD
    reads as EOS; a stream that hit EOS stays stopped."""
    model = served["sessions"]["port"].e.model
    script = [[5, 6, 2, 7, 8], [5, 1, 6, 7, 8]]
    real = model.mt_decoder
    model.mt_decoder = _ScriptedDecoder(script, 16)
    try:
        toks, n, eos = model.mt_decode_greedy(
            torch.tensor([2, 2]), torch.tensor([0, 0]), torch.tensor([budget, 4]),
            [], [], 5)
    finally:
        model.mt_decoder = real
    assert n.tolist() == [emitted, 1]
    assert eos.tolist() == [hit_eos, True]
    assert toks[0].tolist() == [5, 6, 1, 1, 1][:emitted] + [1] * (5 - emitted)
    assert toks[1].tolist() == [5, 1, 1, 1, 1]


def test_stream_cache_appends_each_row_at_its_own_position():
    cache = StreamKVCache.create(2, 4, 1, 2, "cpu", headroom=1)
    one = torch.ones((2, 1, 1, 2))
    cache.index = torch.tensor([0, 0])
    cache.append(one, one)
    cache.index = torch.tensor([0, 1])
    k, _, valid = cache.append(2 * one, 2 * one)
    assert valid.tolist() == [[True, False, False, False], [True, True, False, False]]
    assert k.shape[1] == 4 and k[:, :2, 0, 0].tolist() == [[2.0, 0.0], [1.0, 2.0]]
    cache.index = torch.tensor([1, 2])
    k, _, valid = cache.append(torch.ones((2, 3, 1, 2)), torch.ones((2, 3, 1, 2)))
    assert k.shape[1] == 4 and valid.shape == (2, 4)     # the headroom is not read
    assert cache.capacity == 5
    assert KVCache.create(1, 4, 1, 2, "cpu").index == 0    # the single-stream form


def test_decode_raises_on_the_host_past_the_cache_capacity(served):
    """The port raises where JAX's ``dynamic_update_slice`` clamps, checked
    from the hypotheses' lengths before anything goes to the device."""
    session = served["sessions"]["port"]
    capacity = session.mt_self[0].capacity
    hyps = [[5] * (capacity - 2), [], []]
    with pytest.raises(ValueError, match="overflow"):
        session.e.mt_decode_greedy(session.mt_self, session.mt_cross, hyps, [3, 0, 0])
