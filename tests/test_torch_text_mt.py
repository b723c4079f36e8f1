"""The port's text-to-text simultaneous MT (``models/text_mt.py``,
``models/hmt.py``, ``eval/instance.py`` ``TextToTextInstance`` and
``cli.simuleval``'s ``t2t-*`` agents) against the JAX package's on shared
weights, on the CPU, at tiny text models (two encoder and two decoder layers,
width 32):

- ``TextMTModel`` logits with and without wait-k, and ``HMTModel``'s
  emission and transition logits, each within 2e-4, the candidates equal;
- ``WaitkTextAgent``, ``HMTAgent`` and ``HMTSimBeamAgent`` through each
  package's ``SentenceLevelEvaluator``: the instances' predictions and delays
  and every score equal;
- ``hmt_beam_generate``: tokens equal, scores within 1e-4;
- ``hmt_sim_beam_generate`` through one shared ``step_fn`` (the JAX test's
  constructed HMMs): tokens, read traces, flags and scores equal; and through
  the model itself;
- ``TextToTextInstance`` against JAX's, and one ``t2t-hmt`` CLI run against
  JAX's on one native checkpoint (JAX's CLI reads the port's file).

The weights are the port's seeded init in the flax layout (the text models
have no ``tests/jax_init.py`` entry: no JAX init is needed); the JAX agents
compile a program a shape bucket, so the sentences are short and
``max_len`` small.
"""

import contextlib
import functools
import io
import json

import jax
import numpy as np
import pytest
import torch
from tests.test_hmt import _synthetic_step_fn
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu.cli import simuleval as jax_cli
from streamspeech_tpu.config import DecoderConfig as JaxDecoderConfig
from streamspeech_tpu.dictionary import Dictionary as JaxDictionary
from streamspeech_tpu.eval.evaluator import SentenceLevelEvaluator as JaxEvaluator
from streamspeech_tpu.eval.instance import TextToTextInstance as JaxInstance
from streamspeech_tpu.models import hmt as jax_hmt
from streamspeech_tpu.models import text_mt as jax_text_mt
from streamspeech_tpu.train import checkpoint as jax_ckpt

from streamspeech_tpu_torch.cli import simuleval as port_cli
from streamspeech_tpu_torch.config import DecoderConfig
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.eval.instance import TextToTextInstance
from streamspeech_tpu_torch.models import hmt as port_hmt
from streamspeech_tpu_torch.models.text_mt import TextMTModel, WaitkTextAgent
from streamspeech_tpu_torch.train import checkpoint as port_ckpt
from streamspeech_tpu_torch.weights import flax_variables, random_init_

LOGIT_ATOL = 2e-4
SCORE_ATOL = 1e-4
SRC = ["a b c d e f", "b c a a", "f e d c b a e"]
TGT_WORDS = ["x", "y", "z", "w"] + [f"v{i}" for i in range(16)]
REF = ["x y z w", "y x", "w z y x"]
CLI_MAX_LEN = 12
DEC = dict(embed_dim=32, ffn_embed_dim=64, layers=2, attention_heads=2, dropout=0.0)


def _dicts(cls):
    out = []
    for words in ("a b c d e f", " ".join(TGT_WORDS)):
        d = cls()
        for w in words.split():
            d.add_symbol(w)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def models():
    src_dict, tgt_dict = _dicts(Dictionary)
    v_src, v_tgt = len(src_dict), len(tgt_dict)
    mt = random_init_(TextMTModel(v_src, DecoderConfig(vocab_size=v_tgt, **DEC),
                                  encoder_layers=2), 0).eval()
    hmt = random_init_(port_hmt.HMTModel(v_src, DecoderConfig(vocab_size=v_tgt, **DEC),
                                         encoder_layers=2, first_read=2,
                                         cands_per_token=3), 1).eval()
    with torch.no_grad():       # the special rows' logits 0: the random models write
        mt.decoder.embed_tokens[:4] = 0.0
        hmt.decoder.embed_tokens[:4] = 0.0
    return {
        "mt": mt, "hmt": hmt,
        "jax_mt": jax_text_mt.TextMTModel(v_src, JaxDecoderConfig(vocab_size=v_tgt, **DEC),
                                          encoder_layers=2),
        "jax_hmt": jax_hmt.HMTModel(v_src, JaxDecoderConfig(vocab_size=v_tgt, **DEC),
                                    encoder_layers=2, first_read=2, cands_per_token=3),
        "mt_vars": {"params": flax_variables(mt)["params"]},
        "hmt_vars": {"params": flax_variables(hmt)["params"]},
    }


def _tokens(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(4, 10, (2, 9))
    src[1, 6:] = 1
    prev = rng.randint(4, 8, (2, 7))
    prev[:, 0] = 2
    prev[1, 5:] = 1
    return src, prev


@pytest.mark.parametrize("waitk", [None, 3])
def test_text_mt_logits_match_jax(models, waitk):
    src, prev = _tokens(0)
    apply = jax.jit(models["jax_mt"].apply, static_argnames="waitk")
    want = np.asarray(apply(models["mt_vars"], src, prev, waitk=waitk)["logits"])
    with torch.no_grad():
        got = models["mt"](torch.from_numpy(src), torch.from_numpy(prev), waitk=waitk)
    np.testing.assert_allclose(got["logits"].numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_hmt_logits_match_jax(models):
    src, prev = _tokens(1)
    lens = np.asarray([9, 6])
    em, tr, cands = jax.jit(models["jax_hmt"].apply)(models["hmt_vars"], src, lens, prev)
    with torch.no_grad():
        got = models["hmt"](torch.from_numpy(src), torch.from_numpy(lens),
                            torch.from_numpy(prev))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(em), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(tr), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(cands))
    assert (got[1][..., -1, 0] == port_hmt.NEG).all()   # the last state translates


def test_text_instance_matches_jax():
    got, want = TextToTextInstance(0, "a b c", "x y"), JaxInstance(0, "a b c", "x y")
    for _ in range(4):
        g, w = got.send_source(), want.send_source()
        assert (g.content, g.finished, g.is_empty) == (w.content, w.finished, w.is_empty)
        assert got.step_to_delay() == want.step_to_delay()
    assert got.source_length == want.source_length == 3
    assert got.step_to_elapsed(0.0) == want.step_to_elapsed(0.0) == 0.0


def _agents(models, kind):
    src, tgt = _dicts(Dictionary)
    jsrc, jtgt = _dicts(JaxDictionary)
    if kind == "waitk":
        return (WaitkTextAgent(models["mt"], src, tgt, waitk=2, max_len=10, device="cpu"),
                jax_text_mt.WaitkTextAgent(models["jax_mt"], models["mt_vars"], jsrc, jtgt,
                                           waitk=2, max_len=10))
    if kind == "hmt":
        return (port_hmt.HMTAgent(models["hmt"], src, tgt, max_len=10, device="cpu"),
                jax_hmt.HMTAgent(models["jax_hmt"], models["hmt_vars"], jsrc, jtgt,
                                 max_len=10))
    return (port_hmt.HMTSimBeamAgent(models["hmt"], src, tgt, beam_size=3, max_len=10,
                                     device="cpu"),
            jax_hmt.HMTSimBeamAgent(models["jax_hmt"], models["hmt_vars"], jsrc, jtgt,
                                    beam_size=3, max_len=10))


@pytest.mark.parametrize("kind", ["waitk", "hmt", "hmt_beam"])
def test_agents_match_jax_through_the_evaluator(models, kind):
    port_agent, jax_agent = _agents(models, kind)
    ev, jev = SentenceLevelEvaluator(port_agent), JaxEvaluator(jax_agent)
    got, want = ev(SRC, REF), jev(SRC, REF)
    assert sum(len(ins.delays) for ins in ev.instances.values()) > 0, "wrote nothing"
    for i, ins in ev.instances.items():
        assert isinstance(ins, TextToTextInstance)
        assert ins.prediction == jev.instances[i].prediction, i
        assert ins.delays == jev.instances[i].delays, i
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name] or (got[name] != got[name] and
                                           want[name] != want[name]), name


def test_hmt_beam_generate_matches_jax(models):
    for src_ids in ([4, 5, 6, 7, 8], [9, 4, 4, 6, 5, 7, 8, 9]):
        want = jax_hmt.hmt_beam_generate(models["jax_hmt"], models["hmt_vars"], src_ids,
                                         beam_size=3, max_len=9)
        got = port_hmt.hmt_beam_generate(models["hmt"], src_ids, beam_size=3, max_len=9)
        assert want and [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=SCORE_ATOL, rtol=0)


class _Stub:
    """The fields ``hmt_sim_beam_generate`` reads from a model when a
    ``step_fn`` replaces its step."""

    def __init__(self, first_read, cands_per_token):
        self.first_read, self.cands_per_token = first_read, cands_per_token


@pytest.mark.parametrize("seed,beam,src_finished,prefix", [
    (0, 2, True, None), (1, 4, True, None), (2, 3, False, None), (5, 2, False, None),
    (3, 3, True, [5, 7]), (4, 2, False, [6])])
def test_sim_beam_matches_jax_through_one_step_fn(seed, beam, src_finished, prefix):
    vocab, kk, fr, n_src, max_len = 12, 3, 2, 7, 8
    fn = _synthetic_step_fn(seed, vocab, kk)
    jax_model = jax_hmt.HMTModel.__new__(jax_hmt.HMTModel)
    object.__setattr__(jax_model, "first_read", fr)
    object.__setattr__(jax_model, "cands_per_token", kk)
    kw = dict(prefix_tokens=prefix, beam_size=beam, max_len=max_len, step_fn=fn)
    src_ids = list(range(4, 4 + n_src))
    want = jax_hmt.hmt_sim_beam_generate(jax_model, None, src_ids, src_finished, **kw)
    got = port_hmt.hmt_sim_beam_generate(_Stub(fr, kk), src_ids, src_finished, **kw)
    assert got[1:] == want[1:]                          # return_read_flag, num_read
    assert len(got[0]) == len(want[0])
    for (t_a, s_a, r_a), (t_b, s_b, r_b) in zip(got[0], want[0]):
        assert t_a == t_b and r_a == r_b
        assert s_a == s_b


@pytest.mark.parametrize("src_finished", [True, False])
def test_sim_beam_through_the_model_matches_jax(models, src_finished):
    src_ids = [4, 6, 5, 9, 8, 7]
    kw = dict(num_read_start=3, beam_size=3, max_len=8)
    want = jax_hmt.hmt_sim_beam_generate(models["jax_hmt"], models["hmt_vars"], src_ids,
                                         src_finished, **kw)
    got = port_hmt.hmt_sim_beam_generate(models["hmt"], src_ids, src_finished, **kw)
    assert got[1:] == want[1:]
    assert [(t, r) for t, _, r in got[0]] == [(t, r) for t, _, r in want[0]]
    np.testing.assert_allclose([s for _, s, _ in got[0]], [s for _, s, _ in want[0]],
                               atol=SCORE_ATOL, rtol=0)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_t2t_cli_matches_jax(tmp_path):
    """``t2t-hmt`` on one native checkpoint of a tiny HMT model and its
    dictionaries, through both CLIs, the agents' ``max_len`` set to
    ``CLI_MAX_LEN`` in both."""
    (tmp_path / "src.txt").write_text("\n".join(SRC) + "\n")
    (tmp_path / "tgt.txt").write_text("\n".join(REF) + "\n")
    src_dict, tgt_dict = _dicts(Dictionary)
    src_dict.save(str(tmp_path / "src_dict.txt"))
    tgt_dict.save(str(tmp_path / "tgt_dict.txt"))
    raw = {"decoder": DEC, "encoder_layers": 2, "first_read": 2, "cands_per_token": 3}
    model = random_init_(port_hmt.HMTModel(
        len(src_dict), DecoderConfig(vocab_size=len(tgt_dict), **DEC), encoder_layers=2,
        first_read=2, cands_per_token=3), 4)
    with torch.no_grad():
        model.decoder.embed_tokens[:4] = 0.0
    port_ckpt.save_payload(str(tmp_path / "ck" / "checkpoint_1"),
                           port_ckpt.tensor_tree({"params": flax_variables(model)["params"]}))
    (tmp_path / "ck" / "config.json").write_text(json.dumps(raw))
    outs = {}
    for side, cli in (("port", port_cli), ("jax", jax_cli)):
        argv = ["--source", str(tmp_path / "src.txt"), "--target", str(tmp_path / "tgt.txt"),
                "--agent", "t2t-hmt", "--checkpoint", str(tmp_path / "ck" / "checkpoint_1"),
                "--src-dict", str(tmp_path / "src_dict.txt"), "--tgt-dict",
                str(tmp_path / "tgt_dict.txt"), "--output", str(tmp_path / side), "--cpu"]
        printed = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
            mp.setattr(jax_ckpt, "load_checkpoint",
                       lambda path, target=None: _numpy(port_ckpt.load_checkpoint(path)))
            # both CLIs' agents at a small max_len: JAX compiles a program a
            # target bucket of 8, and the random model writes to the cap
            for module in (jax_hmt, port_hmt):
                mp.setattr(module, "HMTAgent", functools.partial(module.HMTAgent,
                                                                 max_len=CLI_MAX_LEN))
            cli.main(argv)
        outs[side] = (printed.getvalue(),
                      [json.loads(line) for line in
                       (tmp_path / side / "instances.log").read_text().splitlines()])
    (got_printed, got), (want_printed, want) = outs["port"], outs["jax"]
    assert len(got) == len(SRC) and sum(len(x["delays"]) for x in got) > 0
    for g, w in zip(got, want):
        for key in ("index", "prediction", "delays", "source_length", "reference"):
            assert g[key] == w[key], (key, g["index"])
    assert got_printed == want_printed


def test_t2t_agents_raise_without_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the agents run on it")
    src, tgt = _dicts(Dictionary)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WaitkTextAgent(models["mt"], src, tgt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_hmt.HMTAgent(models["hmt"], src, tgt)
