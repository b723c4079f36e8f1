"""The port's offline generation (``streamspeech_tpu_torch/generation.py``)
against the JAX package's on shared weights, on the CPU:

- ``OfflineGenerator.generate`` at beam 1 and beam 4 and
  ``generate_batch_greedy``: the ASR, ST, MT and unit tokens equal to JAX's,
  the MT score within 1e-4. Where JAX's own top-2 log-prob margin at an MT
  step is below 1e-4 (a near-tie, which the port's ~1e-6 different
  log-probs may break the other way), the MT tokens are compared up to that
  step and the step is reported;
- ``block_repeat_ngrams`` on seeded random cases, and the beam search with
  ``no_repeat_ngram_size=2``;
- ``EnsembleGenerator`` with two members: each step's combined log-probs
  within 2e-4 of JAX's and the same outputs; identical members equal one
  model; members of different structure raise, in ``stack_variables`` as in
  the generator;
- the encoder states of an utterance's frames change with how far it is
  padded, in JAX as in the port (ROADMAP §C): equal to JAX's at each padding.

The weights start from ``tests/jax_init.py``'s tiny JAX init (doctored in
the port, so the MT and unit decoders emit), the second ensemble member from
the port's seeded init; each JAX generator is built once a module.
"""

import numpy as np
import pytest
import torch
from tests.jax_init import init_variables, shared_jax_init  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu import generation as jax_gen
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config

from streamspeech_tpu_torch import generation as port_gen
from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.weights import (
    doctor_params,
    flax_variables,
    load_flax_variables,
    random_init_,
)

MAX_LEN = 24
FRAMES = (70, 80, 90)      # all padded to 96: one encode program a JAX generator
TIE = 1e-4          # a JAX top-2 margin below this is a near-tie
SCORE_ATOL = 1e-4
ENSEMBLE_LP_ATOL = 2e-4


def _record_steps(gen):
    """Wrap a generator's MT step so that every step's log-probs [B, V]
    land in ``gen.step_lps`` (cleared by the caller)."""
    step = gen._mt_step
    gen.step_lps = []

    def wrapped(*args):
        out = step(*args)
        lp = out[0] if isinstance(out, tuple) else out
        gen.step_lps.append(np.asarray(lp.detach() if torch.is_tensor(lp) else lp,
                                       np.float64))
        return out

    gen._mt_step = wrapped
    return gen


@pytest.fixture(scope="module")
def stack():
    cfg = tiny_config()
    jm = JaxModel(jax_tiny_config())
    port = doctor_params(load_flax_variables(StreamSpeechModel(cfg),
                                             init_variables(jm, 0))).eval()
    other = doctor_params(random_init_(StreamSpeechModel(cfg), 3)).eval()
    rng = np.random.RandomState(0)
    feats = [rng.randn(n, 80).astype(np.float32) for n in FRAMES]
    return {"cfg": cfg, "jm": jm, "port": port, "other": other,
            "vars": flax_variables(port), "other_vars": flax_variables(other),
            "feats": feats, "jax": {}}


def _jax(stack, key, make):
    """One JAX generator a key a module (its programs compile once)."""
    if key not in stack["jax"]:
        stack["jax"][key] = _record_steps(make())
    gen = stack["jax"][key]
    gen.step_lps = []
    return gen


def _first_tie(lps):
    """The first MT step at which a live row's top-2 margin (PAD excluded)
    is below ``TIE``, or None."""
    for step, lp in enumerate(lps):
        lp = lp.copy()
        lp[:, port_gen.PAD] = -np.inf
        rows = lp[:1] if step == 0 else lp
        top = -np.sort(-rows, axis=1)[:, :2]
        if (top[:, 0] - top[:, 1]).min() < TIE:
            return step
    return None


def _same_result(got, want, jax_lps):
    for key in ("asr_tokens", "st_tokens"):
        assert got[key] == want[key], key
    tie = _first_tie(jax_lps)
    if tie is not None:
        print(f"JAX near-tie (top-2 margin < {TIE}) at MT step {tie}: compared up to it")
        assert got["mt_tokens"][:tie] == want["mt_tokens"][:tie]
        return
    assert got["mt_tokens"] == want["mt_tokens"]
    assert got["units"] == want["units"]
    if "mt_score" in want:
        assert abs(got["mt_score"] - want["mt_score"]) <= SCORE_ATOL


@pytest.mark.parametrize("beam", [1, 4])
def test_generate_matches_jax(stack, beam):
    pg = port_gen.OfflineGenerator(stack["port"], beam=beam, max_len=MAX_LEN, device="cpu")
    for feats in stack["feats"][:2]:
        jg = _jax(stack, beam, lambda: jax_gen.OfflineGenerator(
            stack["jm"], stack["vars"], beam=beam, max_len=MAX_LEN))
        want = jg.generate(feats)
        got = pg.generate(feats)
        assert got["mt_tokens"], "vacuous: the doctored model must emit MT tokens"
        _same_result(got, want, jg.step_lps)


def test_generate_batch_greedy_matches_jax(stack):
    jg = _jax(stack, 1, lambda: jax_gen.OfflineGenerator(
        stack["jm"], stack["vars"], beam=1, max_len=MAX_LEN))
    pg = port_gen.OfflineGenerator(stack["port"], beam=1, max_len=MAX_LEN, device="cpu")
    want = jg.generate_batch_greedy(stack["feats"], max_tokens=12)
    got = pg.generate_batch_greedy(stack["feats"], max_tokens=12)
    assert len(got) == len(want) == len(stack["feats"])
    for g, w in zip(got, want):
        assert g == w
    # each row, padded to 96 frames as alone, also equals its own single run
    for feats, g in zip(stack["feats"], got):
        single = port_gen.OfflineGenerator(stack["port"], beam=1, max_len=12,
                                           device="cpu").generate(feats)
        assert {k: single[k] for k in g} == g


def test_block_repeat_ngrams_matches_jax():
    rng = np.random.RandomState(7)
    for case in range(60):
        b, v, n = int(rng.randint(1, 5)), int(rng.randint(5, 12)), int(rng.randint(0, 4))
        hyps = [list(rng.randint(4, v, int(rng.randint(0, 9)))) for _ in range(b)]
        lp = rng.randn(b, v)
        want = jax_gen.block_repeat_ngrams(lp.copy(), hyps, n)
        got = port_gen.block_repeat_ngrams(lp.copy(), hyps, n)
        np.testing.assert_array_equal(got, want, err_msg=f"case {case}")
    lp = np.zeros((1, 8))
    got = port_gen.block_repeat_ngrams(lp, [[5, 6, 5]], 2)
    assert got[0, 6] == -np.inf and np.isfinite(np.delete(got[0], 6)).all()


def test_no_repeat_ngram_beam_search_matches_jax(stack):
    jg = _jax(stack, 4, lambda: jax_gen.OfflineGenerator(
        stack["jm"], stack["vars"], beam=4, max_len=MAX_LEN))
    pg = port_gen.OfflineGenerator(stack["port"], beam=4, max_len=MAX_LEN,
                                   no_repeat_ngram_size=2, device="cpu")
    jg.no_repeat_ngram_size = 2
    try:
        want = jg.generate(stack["feats"][2])
    finally:
        jg.no_repeat_ngram_size = 0
    got = pg.generate(stack["feats"][2])
    toks = got["mt_tokens"]
    bigrams = list(zip(toks, toks[1:]))
    assert len(bigrams) == len(set(bigrams)), "a repeated bigram was decoded"
    _same_result(got, want, jg.step_lps)


def test_ensemble_matches_jax(stack):
    je = _jax(stack, "ensemble", lambda: jax_gen.EnsembleGenerator(
        stack["jm"], [stack["vars"], stack["other_vars"]], beam=3, max_len=MAX_LEN))
    pe = _record_steps(port_gen.EnsembleGenerator([stack["port"], stack["other"]], beam=3,
                                                  max_len=MAX_LEN, device="cpu"))
    feats = stack["feats"][0]
    want = je.generate(feats)
    got = pe.generate(feats)
    _same_result(got, want, je.step_lps)
    steps = min(len(pe.step_lps), len(je.step_lps), _first_tie(je.step_lps) or MAX_LEN)
    assert steps > 1
    for i in range(steps):
        finite = np.isfinite(je.step_lps[i])
        np.testing.assert_allclose(pe.step_lps[i][finite], je.step_lps[i][finite],
                                   atol=ENSEMBLE_LP_ATOL, rtol=0, err_msg=f"step {i}")
    # the members' probabilities averaged, not one member's
    single = port_gen.OfflineGenerator(stack["port"], beam=3, max_len=MAX_LEN,
                                       device="cpu").generate(feats)
    assert got["mt_score"] != pytest.approx(single["mt_score"], abs=1e-9)
    # the batched greedy path falls back to the per-utterance path, as JAX's
    assert pe.generate_batch_greedy([feats]) == [got]


def test_identical_members_equal_one_model(stack):
    twin = load_flax_variables(StreamSpeechModel(stack["cfg"]), stack["vars"]).eval()
    feats = stack["feats"][1]
    single = port_gen.OfflineGenerator(stack["port"], beam=2, max_len=MAX_LEN,
                                       device="cpu").generate(feats)
    ens = port_gen.EnsembleGenerator([stack["port"], twin], beam=2, max_len=MAX_LEN,
                                     device="cpu").generate(feats)
    assert single["mt_tokens"], "vacuous: the doctored model must emit MT tokens"
    for key in ("asr_tokens", "st_tokens", "mt_tokens", "units"):
        assert ens[key] == single[key], key
    assert ens["mt_score"] == pytest.approx(single["mt_score"], abs=1e-5)


def test_member_mismatch_raises(stack):
    wider = random_init_(StreamSpeechModel(tiny_config(vocab_text=40)), 1)
    with pytest.raises(ValueError, match="member 1 has a different parameter structure"):
        port_gen.EnsembleGenerator([stack["port"], wider], device="cpu")
    with pytest.raises(ValueError, match="at least one member"):
        port_gen.EnsembleGenerator([], device="cpu")
    trees = [stack["vars"], flax_variables(wider)]
    with pytest.raises(ValueError):
        jax_gen.stack_variables(trees)
    with pytest.raises(ValueError, match="member 1 has a different parameter structure"):
        port_gen.stack_variables(trees)
    # members of one structure stack as JAX's do
    both = [stack["vars"], stack["other_vars"]]
    got, want = port_gen.stack_variables(both), jax_gen.stack_variables(both)
    flat = dict(_flat(got))
    for path, leaf in _flat(want):
        np.testing.assert_array_equal(flat[path], np.asarray(leaf), err_msg=path)
    assert len(flat) == len(dict(_flat(want)))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_generator_raises_without_card(stack):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the generator runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_gen.OfflineGenerator(stack["port"])


def test_encoder_states_depend_on_padding_as_jax(stack):
    """The encoder states of an utterance's valid frames change with how far
    the batch pads it, in JAX as in the port (so a batched greedy row padded
    further than its single run may decode differently): the port equals
    JAX at each padding."""
    import jax.numpy as jnp

    jg = _jax(stack, 1, lambda: jax_gen.OfflineGenerator(
        stack["jm"], stack["vars"], beam=1, max_len=MAX_LEN))
    pg = port_gen.OfflineGenerator(stack["port"], beam=1, device="cpu")
    feats = stack["feats"][2]
    t = feats.shape[0]
    encs = {}
    for pad in (96, 320):
        src = np.zeros((1, pad, 80), np.float32)
        src[0, :t] = feats
        enc, lens, _, _ = jg._encode(jg.variables, jnp.asarray(src), jnp.asarray([t]),
                                     chunk=port_gen.NO_CHUNK, conv_chunk=port_gen.NO_CHUNK)
        want = np.asarray(enc)[0, :int(lens[0])]
        (got,), _, _, _ = pg._encode(src, np.asarray([t]), port_gen.NO_CHUNK,
                                     port_gen.NO_CHUNK)
        got = got[0, :int(lens[0])].detach().numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0, err_msg=f"pad {pad}")
        encs[pad] = want
    assert np.abs(encs[96] - encs[320]).max() > 1e-3
