"""The port's weight helpers: the flax bridge is strict, the port's doctoring
equals the JAX tests' doctoring, and the seeded init is deterministic with its
residual-branch outputs scaled."""

import copy

import jax
import numpy as np
import pytest
import torch

from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import init_params
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config
from tests.test_batched_eval import doctor_params as jax_doctor_params

from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.weights import (
    _residual_scales,
    doctor_params,
    load_flax_variables,
    random_init_,
)


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxModel(jax_tiny_config())
    variables = jax.jit(lambda k: init_params(model, k))(jax.random.PRNGKey(0))
    doctored = jax_doctor_params(jax.tree.map(lambda x: x, variables))
    return jax.tree.map(np.asarray, variables), jax.tree.map(np.asarray, doctored)


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_port_doctoring_matches_jax_doctoring(jax_variables):
    plain, doctored = jax_variables
    port = doctor_params(load_flax_variables(StreamSpeechModel(tiny_config()), plain))
    ref = load_flax_variables(StreamSpeechModel(tiny_config()), doctored)
    got, want = _state(port), _state(ref)
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0,
                                   msg=name)


def _add_leaf(v):
    v["params"]["mt_decoder"]["extra"] = np.zeros(3, np.float32)


def _drop_leaf(v):
    del v["params"]["source_unigram_head"]["proj"]["bias"]


def _drop_stat(v):
    stats = v["batch_stats"]["encoder"]["layers_0"]["conv_module"]["batch_norm"]
    del stats["var"]


def _reshape_leaf(v):
    proj = v["params"]["ctc_target_unigram_head"]["proj"]
    proj["kernel"] = proj["kernel"][:, :-1]


@pytest.mark.parametrize("mutate,message", [
    (_add_leaf, r"home: \['mt_decoder\.extra'\]"),
    (_drop_leaf, r"unset: \['source_unigram_head\.proj\.bias'\]"),
    (_drop_stat, r"unset: \['encoder\.layers_0\.conv_module\.batch_norm\.running_var'\]"),
    (_reshape_leaf, r"ctc_target_unigram_head\.proj\.weight: flax"),
])
def test_bridge_is_strict(jax_variables, mutate, message):
    variables = copy.deepcopy(jax_variables[0])
    mutate(variables)
    with pytest.raises(ValueError, match=message):
        load_flax_variables(StreamSpeechModel(tiny_config()), variables)


def test_random_init_is_seeded():
    a = _state(random_init_(StreamSpeechModel(tiny_config()), 3))
    b = _state(random_init_(StreamSpeechModel(tiny_config()), 3))
    c = _state(random_init_(StreamSpeechModel(tiny_config()), 4))
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, msg=name)
    assert any(not torch.equal(a[n], c[n]) for n in a)


def test_random_init_scales_residual_branches():
    cfg = tiny_config()
    model = random_init_(StreamSpeechModel(cfg), 0)
    branches = {"encoder": 4 * cfg.encoder.layers,
                "mt_decoder": 3 * cfg.mt_decoder.layers,
                "synthesizer_encoder": 2 * cfg.synthesizer_encoder_layers,
                "unit_decoder": 3 * cfg.unit_decoder.layers}
    scales = _residual_scales(model)
    assert sum(branches.values()) == len(scales)
    for name, scale in scales.items():
        assert scale == branches[name.split(".")[0]] ** -0.5, name
    # N(0, 1/fan_in) times the branch scale
    w = dict(model.named_parameters())["encoder.layers_0.ffn1.w_2.weight"]
    want = w.shape[1] ** -0.5 * branches["encoder"] ** -0.5
    assert abs(float(w.detach().std()) / want - 1) < 0.1
