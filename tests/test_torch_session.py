"""The serving slice as a whole: the port's S2ST agent against the JAX agent.

Same doctored tiny model and vocoder weights in both packages (moved by
``streamspeech_tpu_torch.weights``), same synthetic audio, same 320 ms segments.
On every turn the MT hypothesis, the emitted units and their durations must be
identical and the written wav within 1e-4. The JAX agent takes its synchronous
host policy (its fused single-program policy is held equal to the host path by
tests/test_fused_policy.py); the port implements that host path.
"""

import jax
import numpy as np
import pytest

from streamspeech_tpu.agents.streamspeech import (
    StreamSpeechAgentConfig as JaxAgentConfig,
    StreamSpeechS2STAgent as JaxAgent,
)
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import init_params
from streamspeech_tpu.models.vocoder import CodeGenerator as JaxVocoder
from streamspeech_tpu.runtime.session import StreamSpeechEngine as JaxEngine
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config
from tests.test_batched_eval import doctor_params, make_dicts
from tests.test_torch_vocoder import numpy_vocoder_variables
from tests.test_vocoder import tiny_cfg as tiny_vocoder_cfg

from streamspeech_tpu_torch.agents.base import stream_utterance
from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechS2STAgent,
)
from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.vocoder import CodeGenerator
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine, _bucket
from streamspeech_tpu_torch.weights import load_flax_variables, load_flax_vocoder

ENGINE_SIZES = dict(max_enc_frames=128, max_mt_tokens=32, mt_buckets=(8, 16, 32),
                    unit_buckets=(16, 32, 64))


def _record_emissions(engine, log):
    """Make every new session of ``engine`` log (units, durations) of each
    emission it makes."""
    new_session = engine.new_session

    def recording_session():
        sess = new_session()
        inner = sess.emit_tail

        def emit_tail(n_prev_units):
            units, wav, dur = inner(n_prev_units)
            log.append((list(units), np.asarray(dur)))
            return units, wav, dur
        sess.emit_tail = emit_tail
        return sess
    engine.new_session = recording_session


@pytest.fixture(scope="module")
def agents():
    # an encoder narrower than the decoders, as in full_config (256 vs 512)
    cfg = jax_tiny_config()
    cfg.encoder.embed_dim = 24
    pcfg = tiny_config()
    pcfg.encoder.embed_dim = 24
    jmodel = JaxModel(cfg)
    jvars = doctor_params(jax.jit(lambda k: init_params(jmodel, k))(
        jax.random.PRNGKey(0)))
    voc_cfg = tiny_vocoder_cfg()
    voc_cfg["num_embeddings"] = cfg.unit_decoder.vocab_size - 4
    jvoc = JaxVocoder(voc_cfg)
    jvoc_vars = numpy_vocoder_variables(jvoc, 1)
    jengine = JaxEngine(jmodel, jvars, jvoc, jvoc_vars, **ENGINE_SIZES)
    src_dict, unit_dict = make_dicts(cfg.mt_decoder.vocab_size, 19)
    jagent = JaxAgent(jengine, JaxAgentConfig(), src_dict, src_dict, unit_dict)
    jagent._starts_word = None  # the synchronous host policy

    model = load_flax_variables(StreamSpeechModel(pcfg),
                                jax.tree.map(np.asarray, jvars))
    vocoder = load_flax_vocoder(CodeGenerator(voc_cfg),
                                jvoc_vars)
    engine = StreamSpeechEngine(model, vocoder, device="cpu", **ENGINE_SIZES)
    p_dict = Dictionary()
    for i in range(cfg.mt_decoder.vocab_size - 4):
        p_dict.add_symbol("▁w" + str(i))
    p_units = Dictionary.units(19)
    p_units.add_blank()
    agent = StreamSpeechS2STAgent(engine, StreamSpeechAgentConfig(), p_dict,
                                  p_dict, p_units)
    logs = {"jax": [], "port": []}
    _record_emissions(jengine, logs["jax"])
    _record_emissions(engine, logs["port"])
    return {"jax": jagent, "port": agent}, logs


def _turns(agent, log, samples):
    """Per turn: (MT tokens, units, [(units, durations) emitted], wav, finished)."""
    turns = []
    log.clear()
    for out in stream_utterance(agent, samples):
        emitted = list(log)
        log.clear()
        wav = np.asarray([] if out.is_empty else out.content, np.float32)
        turns.append((list(agent.session.mt_tokens), list(agent.units), emitted,
                      wav, out.finished))
    return turns


@pytest.mark.parametrize("seed,n_samples", [(5, 19200), (7, 11000), (11, 16000)])
def test_port_agent_matches_jax_agent(agents, seed, n_samples):
    ags, logs = agents
    samples = np.random.RandomState(seed).uniform(-0.3, 0.3, n_samples)
    jturns = _turns(ags["jax"], logs["jax"], samples)
    pturns = _turns(ags["port"], logs["port"], samples)

    assert len(pturns) == len(jturns)
    for t, (j, p) in enumerate(zip(jturns, pturns)):
        assert p[0] == j[0], f"turn {t}: MT tokens differ"
        assert p[1] == j[1], f"turn {t}: units differ"
        assert len(p[2]) == len(j[2]), f"turn {t}: emission count differs"
        for (ju, jd), (pu, pd) in zip(j[2], p[2]):
            assert pu == ju, f"turn {t}: emitted units differ"
            np.testing.assert_array_equal(pd, jd, err_msg=f"turn {t} durations")
        assert p[4] == j[4], f"turn {t}: finished flag differs"
        assert p[3].shape == j[3].shape, f"turn {t}: wav length differs"
        np.testing.assert_allclose(p[3], j[3], atol=1e-4, err_msg=f"turn {t}")
    # non-vacuous: the doctored model really decodes, emits and speaks
    assert len(jturns[-1][0]) > 0, "no MT token was written"
    assert len(jturns[-1][1]) > 0, "no unit was written"
    assert sum(len(t[2]) for t in jturns) > 0, "nothing was emitted"
    assert sum(len(t[3]) for t in jturns) > 0, "no wav was written"


def test_session_methods_match_jax(agents):
    """The session's building blocks one by one on the same pushed features:
    MT decoding, whole-word truncation, unit synthesis, full and tail emission
    and plain vocoding."""
    ags, _ = agents
    jses, pses = ags["jax"].engine.new_session(), ags["port"].engine.new_session()
    feats = np.random.RandomState(3).randn(72, 80).astype(np.float32) * 0.5
    assert pses.push_features(feats, 8, 8) == jses.push_features(feats, 8, 8)
    assert pses.ctc_hypotheses() == jses.ctc_hypotheses()
    assert pses.mt_decode(6) == jses.mt_decode(6)
    jses.mt_truncate(4)
    pses.mt_truncate(4)
    assert pses.mt_decode(3) == jses.mt_decode(3)
    assert len(jses.mt_tokens) > 0, "vacuous: nothing decoded"
    blank = ags["jax"].unit_blank
    assert pses.synthesize_units() == jses.synthesize_units(blank)
    (ju, jw, jd), (pu, pw, pd) = jses.emit(), pses.emit()
    assert pu == ju and len(ju) > 0
    np.testing.assert_array_equal(pd, np.asarray(jd))
    np.testing.assert_allclose(pw, np.asarray(jw), atol=1e-4)
    for n_prev in (0, 1):
        (ju, jw, jd), (pu, pw, pd) = jses.emit_tail(n_prev), pses.emit_tail(n_prev)
        assert pu == ju
        np.testing.assert_array_equal(pd, np.asarray(jd))
        np.testing.assert_allclose(pw, np.asarray(jw), atol=1e-4)
    codes = [3, 0, 7, 7, 12]
    (jw, jd), (pw, pd) = jses.vocode(codes), pses.vocode(codes)
    np.testing.assert_array_equal(pd, np.asarray(jd))
    np.testing.assert_allclose(pw, np.asarray(jw), atol=1e-4)


def test_bucket_raises_past_last_bucket():
    assert _bucket(16, (16, 32)) == 16
    assert _bucket(17, (16, 32)) == 32
    with pytest.raises(ValueError):
        _bucket(33, (16, 32))
