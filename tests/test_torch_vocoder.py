"""The port's CodeHiFiGAN against the JAX vocoder at tiny channels but the
production kernel/dilation/upsample structure (tests/test_emit_tail.py), with
weights moved by ``streamspeech_tpu_torch.weights``. atol 1e-4 (fp32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.models.vocoder import CodeGenerator as JaxCodeGenerator
from tests.test_emit_tail import rf_vocoder_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.models.vocoder import (
    CodeGenerator,
    expand_by_durations,
    expand_window_by_durations,
)
from streamspeech_tpu_torch.weights import load_flax_vocoder

ATOL = 1e-4


def numpy_vocoder_variables(vocoder, seed):
    """Random variables for a JAX CodeGenerator built from its shapes alone
    (``jax.eval_shape``: nothing is compiled): LayerNorm scales 1, biases 0,
    every other weight N(0, 1/fan_in), so the waveform is O(0.1), not ~0."""
    shapes = jax.eval_shape(functools.partial(vocoder.init, max_frames=8),
                            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "bias" or name.endswith("_b"):
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def vocoders():
    cfg = rf_vocoder_cfg()
    jvoc = JaxCodeGenerator(cfg)
    jvars = numpy_vocoder_variables(jvoc, 0)
    # a duration bias so predicted durations spread over 1..4 frames
    jvars["params"]["dur_predictor"]["proj"]["bias"] = np.ones(1, np.float32)
    pvoc = load_flax_vocoder(CodeGenerator(cfg), jvars).eval()
    return cfg, jvoc, jvars, pvoc


def _codes(cfg, t, seed):
    return np.random.RandomState(seed).randint(0, cfg["num_embeddings"], (2, t))


def test_predict_durations(vocoders):
    cfg, jvoc, jvars, pvoc = vocoders
    codes = _codes(cfg, 30, 0)
    jdur = np.asarray(jvoc.apply(jvars, jnp.asarray(codes),
                                 method=JaxCodeGenerator.predict_durations))
    with torch.no_grad():
        pdur = pvoc.predict_durations(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(pdur, jdur)
    assert len(np.unique(jdur)) > 1, "durations all equal: test is vacuous"


@pytest.mark.parametrize("given_durations", [False, True])
def test_code_generator_full(vocoders, given_durations):
    cfg, jvoc, jvars, pvoc = vocoders
    codes = _codes(cfg, 12, 1)
    dur = np.random.RandomState(2).randint(0, 4, (2, 12)) if given_durations else None
    jwav, jn, jdur = jvoc.apply(jvars, jnp.asarray(codes),
                                None if dur is None else jnp.asarray(dur),
                                max_frames=40)
    with torch.no_grad():
        pwav, pn, pdur = pvoc(torch.from_numpy(codes),
                              None if dur is None else torch.from_numpy(dur),
                              max_frames=40)
    np.testing.assert_array_equal(pdur.numpy(), np.asarray(jdur))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pwav.numpy(), np.asarray(jwav), atol=ATOL)
    assert np.abs(np.asarray(jwav)).max() > 1e-2, "waveform ~0: test is vacuous"


@pytest.mark.parametrize("start", [0, 5, 37])
def test_vocode_window(vocoders, start):
    cfg, jvoc, jvars, pvoc = vocoders
    codes = _codes(cfg, 20, 3)
    dur = np.random.RandomState(4).randint(1, 5, (2, 20))
    starts = np.array([start, start // 2])
    jwav, jn = jvoc.apply(jvars, jnp.asarray(codes), jnp.asarray(dur),
                          jnp.asarray(starts), 32,
                          method=JaxCodeGenerator.vocode_window)
    with torch.no_grad():
        pwav, pn = pvoc.vocode_window(torch.from_numpy(codes), torch.from_numpy(dur),
                                      torch.from_numpy(starts), 32)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pwav.numpy(), np.asarray(jwav), atol=ATOL)


def test_expand_by_durations_is_repeat_interleave():
    x = torch.arange(12, dtype=torch.float32).view(1, 4, 3)
    dur = torch.tensor([[2, 0, 1, 3]])
    out, n = expand_by_durations(x, dur, 8)
    want = torch.repeat_interleave(x[0], dur[0], dim=0)
    assert int(n[0]) == 6
    torch.testing.assert_close(out[0, :6], want)
    assert float(out[0, 6:].abs().sum()) == 0.0
    win, n_valid = expand_window_by_durations(x, dur, torch.tensor([4]), 4)
    torch.testing.assert_close(win[0, :2], want[4:])
    assert int(n_valid[0]) == 2
