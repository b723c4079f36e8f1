"""The tiny serving stack of ``tests/test_torch_session.py``, built once for the
batched serving tests: one doctored JAX StreamSpeech model and vocoder and the
port's counterparts on the same weights (``weights.load_flax_variables`` /
``load_flax_vocoder``), each behind its own engine; the encoder at 24 wide,
narrower than the decoders, as in ``full_config``."""

import jax
import numpy as np

from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import init_params
from streamspeech_tpu.models.vocoder import CodeGenerator as JaxVocoder
from streamspeech_tpu.runtime.session import StreamSpeechEngine as JaxEngine
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config
from tests.test_batched_eval import doctor_params, make_dicts
from tests.test_torch_vocoder import numpy_vocoder_variables
from tests.test_vocoder import tiny_cfg as tiny_vocoder_cfg

from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.vocoder import CodeGenerator
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
from streamspeech_tpu_torch.weights import load_flax_variables, load_flax_vocoder

ENGINE_SIZES = dict(max_enc_frames=128, max_mt_tokens=32, mt_buckets=(8, 16, 32),
                    unit_buckets=(16, 32, 64))


def build_stack(port_dtype=None):
    """Returns dict(jax=JAX engine, port=port engine (CPU), jdicts=(text,
    units) of the JAX package, pdicts=(text, units) of the port, and, with
    ``port_dtype``, port_lp: a second port engine on the same weights whose
    model computes in that dtype)."""
    cfg = jax_tiny_config()
    cfg.encoder.embed_dim = 24
    pcfg = tiny_config()
    pcfg.encoder.embed_dim = 24
    jmodel = JaxModel(cfg)
    jvars = doctor_params(jax.jit(lambda k: init_params(jmodel, k))(jax.random.PRNGKey(0)))
    voc_cfg = tiny_vocoder_cfg()
    voc_cfg["num_embeddings"] = cfg.unit_decoder.vocab_size - 4
    jvoc = JaxVocoder(voc_cfg)
    jvoc_vars = numpy_vocoder_variables(jvoc, 1)
    jengine = JaxEngine(jmodel, jvars, jvoc, jvoc_vars, **ENGINE_SIZES)
    np_vars = jax.tree.map(np.asarray, jvars)

    def port_engine(**model_kw):
        model = load_flax_variables(StreamSpeechModel(pcfg, **model_kw), np_vars)
        vocoder = load_flax_vocoder(CodeGenerator(voc_cfg), jvoc_vars)
        return StreamSpeechEngine(model, vocoder, device="cpu", **ENGINE_SIZES)

    p_text = Dictionary()
    for i in range(cfg.mt_decoder.vocab_size - 4):
        p_text.add_symbol("▁w" + str(i))
    p_units = Dictionary.units(19)
    p_units.add_blank()
    out = {"jax": jengine, "port": port_engine(),
           "jdicts": make_dicts(cfg.mt_decoder.vocab_size, 19), "pdicts": (p_text, p_units)}
    if port_dtype is not None:
        out["port_lp"] = port_engine(dtype=port_dtype)
    return out
