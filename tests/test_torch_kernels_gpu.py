"""The CUDA kernels against their plain PyTorch versions, on a Hopper card.

Imports neither jax nor the JAX package, so it runs on a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Elsewhere every test here skips.
"""

import numpy as np
import pytest
import torch

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF

ATOL = 1e-5  # fp32 both sides; the sums run in a different order


def _inputs(b, h, t, d, seed, n_valid):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    valid = np.arange(t)[None, :] < np.asarray(n_valid)[:, None]
    kvb = np.where(valid, 0.0, NEG_INF).astype(np.float32)[:, None, :]
    return q, k, v, kvb


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("t_pad,n_valid", [(512, 400), (896, 800), (1664, 1600),
                                           (3200, 3200)])
def test_cuda_kernel_matches_plain_version(hopper, t_pad, n_valid):
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(1, 8, t_pad, 64, seed=t_pad,
                                      n_valid=[n_valid]))
    before = attention.masked_attention.launches
    got = attention.masked_attention(q, k, v, kvb, 0.125)
    torch.cuda.synchronize()
    assert attention.masked_attention.launches == before + 1
    want = attention.masked_attention_reference(q, k, v, kvb, 0.125)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32])
def test_cuda_kernel_small_heads(hopper, d):
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(2, 2, 256, d, seed=d, n_valid=[200, 256]))
    got = attention.masked_attention(q, k, v, kvb, d ** -0.5)
    want = attention.masked_attention_reference(q, k, v, kvb, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 24, 40, 128, 256])
def test_cuda_kernel_other_head_dims(hopper, d):
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(1, 2, 320, d, seed=d, n_valid=[300]))
    got = attention.masked_attention(q, k, v, kvb, d ** -0.5)
    want = attention.masked_attention_reference(q, k, v, kvb, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_causal_route_launches_the_kernel_at_an_odd_head_dim(hopper):
    """T=300 and head dim 24 pass the TPU gate, so the card runs the kernel
    (forward-only: under ``no_grad``, as the serving path and the forward run)."""
    from streamspeech_tpu_torch.models.layers import MultiHeadAttention

    torch.manual_seed(0)
    mha = MultiHeadAttention(48, 2).to(hopper)
    x = torch.randn(1, 300, 48, device=hopper)
    before = attention.masked_attention.launches
    with torch.no_grad():
        got, _ = mha(x, causal=True)
        assert attention.masked_attention.launches == before + 1
        want, _ = mha.cpu()(x.cpu(), causal=True)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(hopper):
    q = torch.zeros(1, 2, 100, 64, device=hopper)   # T not a multiple of 64
    kvb = torch.zeros(1, 1, 100, device=hopper)
    with pytest.raises(ValueError):
        attention.masked_attention(q, q, q, kvb, 0.125)
    wide = torch.zeros(1, 2, 128, 264, device=hopper)  # head dim past 256
    with pytest.raises(ValueError):
        attention.masked_attention(wide, wide, wide, kvb[..., :0].new_zeros(1, 1, 128),
                                   264 ** -0.5)


def _relpos_inputs(b, h, t, d, seed, n_valid, chunk, bias_heads=1):
    rng = np.random.RandomState(seed)
    qu, qv, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = (j < np.minimum((i // chunk + 1) * chunk, t))[None, None] & \
        (np.arange(t)[None, None, None, :] < np.asarray(n_valid)[:, None, None, None])
    bias = np.where(allowed, 0.0, NEG_INF).astype(np.float32)
    bias = np.repeat(bias, bias_heads, axis=1)
    return qu, qv, k, v, p, bias


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,bias_heads", [(1, 256, 64, 1), (8, 256, 64, 1),
                                              (1, 512, 64, 4), (2, 128, 24, 1),
                                              (1, 128, 136, 1), (1, 128, 144, 4),
                                              (1, 64, 256, 1), (1, 64, 8, 1)])
def test_relpos_kernel_matches_plain_version(hopper, b, t, d, bias_heads):
    args = [torch.from_numpy(a).to(hopper) for a in _relpos_inputs(
        b, 4, t, d, seed=t + d, n_valid=[t - 40] + [t] * (b - 1), chunk=8,
        bias_heads=bias_heads)]
    before = attention.relpos_attention.launches
    got = attention.relpos_attention(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.relpos_attention.launches == before + 1
    want = attention.relpos_attention_reference(*args, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def _bias_inputs(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    # the unit decoder's wait-k mask (n2 = 1, upsample 25) and key validity
    allowed = np.arange(tk)[None, None, :] < np.minimum(
        np.arange(tq)[None, :, None] // 25 + 1, tk)
    allowed = allowed & (np.arange(tk)[None, None, :]
                         < np.array([tk] + [tk - 5] * (b - 1))[:, None, None])
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,tq,tk,d", [(1, 600, 24, 64), (8, 1200, 48, 64),
                                       (2, 70, 130, 16), (1, 100, 3, 256),
                                       (1, 64, 64, 8)])
def test_bias_kernel_matches_plain_version(hopper, b, tq, tk, d):
    args = [torch.from_numpy(a).to(hopper)
            for a in _bias_inputs(b, 8, tq, tk, d, seed=tq + tk)]
    before = attention.bias_attention.launches
    got = attention.bias_attention(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.bias_attention.launches == before + 1
    want = attention.bias_attention_reference(*args, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,v,blank", [(1, 256, 6000, 0), (8, 256, 6000, 0),
                                         (3, 7, 130, 5), (1, 1, 512, 0)])
def test_not_blank_kernel_matches_plain_version(hopper, b, t, v, blank):
    from streamspeech_tpu_torch.kernels import policy

    logits = torch.from_numpy(np.random.RandomState(t).randn(b, t, v).astype(
        np.float32) * 4).to(hopper)
    before = policy.not_blank_probs.launches
    got = policy.not_blank_probs(logits, blank)
    torch.cuda.synchronize()
    assert policy.not_blank_probs.launches == before + 1
    want = policy.not_blank_probs_reference(logits, blank)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_new_wrappers_raise_instead_of_falling_back(hopper):
    from streamspeech_tpu_torch.kernels import policy

    q = torch.zeros(1, 2, 100, 64, device=hopper)      # T not a multiple of 64
    p = torch.zeros(2, 199, 64, device=hopper)
    bias = torch.zeros(1, 1, 100, 100, device=hopper)
    with pytest.raises(ValueError):
        attention.relpos_attention(q, q, q, q, p, bias, 0.125)
    wide = torch.zeros(1, 2, 64, 264, device=hopper)   # head dim past 256
    with pytest.raises(ValueError):
        attention.bias_attention(wide, wide, wide, torch.zeros(1, 64, 64, device=hopper),
                                 264 ** -0.5)
    with pytest.raises(ValueError):                    # not float32
        policy.not_blank_probs(torch.zeros(1, 64, 512, device=hopper,
                                           dtype=torch.float64))


@pytest.mark.gpu
def test_offline_forward_on_the_card_matches_the_cpu(hopper):
    """The tiny model's offline forward takes all four kernels on the card
    (T_enc 256, S 600) and agrees with its CPU run (plain versions)."""
    from streamspeech_tpu_torch.config import tiny_config
    from streamspeech_tpu_torch.kernels import policy
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.weights import random_init_

    model = random_init_(StreamSpeechModel(tiny_config(vocab_text=512, upsample=25)),
                         0).eval()
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randn(2, 1024, 80).astype(np.float32))
    lens = torch.tensor([1024, 800])
    mt = torch.from_numpy(rng.randint(4, 512, size=(2, 24)))
    mt[:, 0], mt[1, 18:] = 2, 1
    with torch.no_grad():
        want = model(src, lens, mt, n2=1)
        counts = [f.launches for f in (attention.relpos_attention,
                                       attention.bias_attention,
                                       attention.masked_attention,
                                       policy.not_blank_probs)]
        got = model.to(hopper)(src.to(hopper), lens.to(hopper), mt.to(hopper), n2=1)
    after = [f.launches for f in (attention.relpos_attention, attention.bias_attention,
                                  attention.masked_attention, policy.not_blank_probs)]
    assert [a - c for a, c in zip(after, counts)] == [2, 1, 1, 2]
    for key, ref in want.items():
        torch.testing.assert_close(got[key].cpu(), ref, atol=1e-4, rtol=0, msg=key)


def _ctc_parts(b, t, v, n, seed, device, n_valid=None, label_lengths=None, blank=0):
    """The DP inputs of one CTC head (``kernels.ctc.ext_and_masks``) from
    numpy-seeded logits and labels."""
    from streamspeech_tpu_torch.kernels import ctc

    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(b, t, v).astype(np.float32) * 2).to(device)
    labels = torch.from_numpy(rng.randint(1, v, size=(b, n))).to(device)
    lengths = torch.tensor(n_valid if n_valid is not None else [t] * b, device=device)
    lab_len = torch.tensor(label_lengths if label_lengths is not None else [n] * b,
                           device=device)
    return ctc.ext_and_masks(logits, lengths, labels, lab_len, blank)


def _within(got, want, rel):
    """|got - want| <= rel * max(1, |want|), elementwise."""
    err = (got - want).abs()
    return bool((err <= rel * want.abs().clamp(min=1.0)).all()), float(err.max())


def _pad_states(parts, s):
    """The DP inputs padded to ``s`` states with unreachable ones (NNEG log-probs
    and masks), as the fused multi-head launch pads its heads."""
    from streamspeech_tpu_torch.kernels import ctc

    extra = s - parts["lp_ext"].shape[2]
    return {k: (v if k == "validmask" else
                torch.nn.functional.pad(v, (0, extra), value=ctc.NNEG))
            for k, v in parts.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,v,n,n_valid,label_lengths,s_cut", [
    (8, 1200, 1005, 256, None, None, None),        # the train step's unit CTC
    (16, 256, 6000, 32, None, None, None),         # the fused ASR + ST pair
    (1, 1200, 1005, 256, None, None, None),        # one row, S = 513: one cluster
    (2, 300, 900, 800, [300, 290], [800, 700], None),   # S = 1601 > 1024
    (3, 37, 40, 5, [37, 20, 1], [5, 0, 2], None),  # odd T, padded frames, empty labels
    (1, 3, 8, 4, [3], [4], None),                  # more labels than frames
    # the cluster's cut: S exactly 3 blocks of states (the last state padded
    # in), S one state past one block, the largest odd S (16 blocks a cluster)
    (2, 700, 300, None, [700, 650], None, "multiple"),
    (3, 200, 300, None, [200, 150, 180], None, "plus_one"),
    (1, 2100, 100, 2047, None, None, None),
    (1, 1000, 1005, 256, [900], [250], None),      # B = 1, S = 513, padded frames
])
def test_ctc_kernels_match_plain_versions(hopper, b, t, v, n, n_valid, label_lengths,
                                          s_cut):
    from streamspeech_tpu_torch.kernels import ctc

    s_target = None
    if s_cut is not None:
        w = ctc.cluster_plan(513)["states_per_block"]
        s_target = 3 * w if s_cut == "multiple" else w + 1
        n = (s_target - 1) // 2
    parts = _ctc_parts(b, t, v, n, seed=t + n, device=hopper, n_valid=n_valid,
                       label_lengths=label_lengths)
    if s_target is not None:
        parts = _pad_states(parts, s_target)
        assert parts["lp_ext"].shape[2] == s_target
    lp, init, end, skip, valid = (parts[k].contiguous() for k in (
        "lp_ext", "initmask", "endmask", "skipmask", "validmask"))
    before = (ctc.ctc_alpha.launches, ctc.ctc_beta_grad.launches)
    alpha = ctc.ctc_alpha(lp, init, skip, valid)
    want_alpha = ctc.ctc_alpha_reference(lp, init, skip, valid)
    ok, err = _within(alpha, want_alpha, 1e-5)
    assert ok, f"alpha differs by {err}"
    nll, logz = ctc.nll_from_alpha(alpha, end)
    want_nll, _ = ctc.nll_from_alpha(want_alpha, end)
    ok, err = _within(nll, want_nll, 1e-5)
    assert ok, f"nll differs by {err}"
    zbias = torch.where(logz > ctc.NNEG / 2, -logz, torch.full_like(logz, ctc.NNEG))
    grad = ctc.ctc_beta_grad(lp, end, skip, zbias, valid, alpha)
    torch.cuda.synchronize()
    assert (ctc.ctc_alpha.launches, ctc.ctc_beta_grad.launches) == \
        (before[0] + 1, before[1] + 1)
    want_grad = ctc.ctc_beta_grad_reference(lp, end, skip, zbias, valid, want_alpha)
    torch.testing.assert_close(grad, want_grad, atol=1e-6, rtol=0)
    if t < n:                                          # impossible: grad exactly 0
        assert float(nll.min()) > 1e29 and not grad.any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,v,n", [(8, 1200, 1005, 256), (16, 256, 6000, 32)])
def test_ctc_kernels_bit_identical_twice(hopper, b, t, v, n):
    """No atomics and a fixed order of every sum: two calls give the same bits."""
    from streamspeech_tpu_torch.kernels import ctc

    parts = _ctc_parts(b, t, v, n, seed=3, device=hopper, n_valid=[t] * (b - 1) + [t - 9])
    lp, init, end, skip, valid = (parts[k].contiguous() for k in (
        "lp_ext", "initmask", "endmask", "skipmask", "validmask"))
    alphas = [ctc.ctc_alpha(lp, init, skip, valid) for _ in range(2)]
    _, logz = ctc.nll_from_alpha(alphas[0], end)
    zbias = torch.where(logz > ctc.NNEG / 2, -logz, torch.full_like(logz, ctc.NNEG))
    grads = [ctc.ctc_beta_grad(lp, end, skip, zbias, valid, alphas[0]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(alphas[0], alphas[1])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.gpu
def test_ctc_cluster_plan_covers_every_state_count(hopper):
    """The cut fits the cluster limit and holds every state, S = 1 to 4096."""
    from streamspeech_tpu_torch.kernels import ctc

    for s in list(range(1, 70)) + [129, 513, 1601, 2049, 4095, 4096]:
        plan = ctc.cluster_plan(s)
        assert 1 <= plan["cluster_size"] <= 16
        assert plan["cluster_size"] * plan["states_per_block"] >= s
        assert (plan["cluster_size"] - 1) * plan["states_per_block"] < s


@pytest.mark.gpu
def test_ctc_autograd_function_matches_the_plain_path(hopper):
    """d loss / d logits through CTCNll (alpha and beta kernels) against
    autograd through the scan form, both on the card."""
    from streamspeech_tpu_torch.kernels import ctc
    from streamspeech_tpu_torch.ops.ctc import ctc_neg_log_likelihood

    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(4, 60, 30).astype(np.float32)).to(hopper)
    labels = torch.from_numpy(rng.randint(1, 30, size=(4, 12))).to(hopper)
    lengths = torch.tensor([60, 51, 40, 3], device=hopper)
    lab_len = torch.tensor([12, 7, 0, 12], device=hopper)
    grads, values = [], []
    for fn in (ctc.ctc_neg_log_likelihood_kernel, ctc_neg_log_likelihood):
        x = logits.clone().requires_grad_()
        nll = fn(x, lengths, labels, lab_len, 0)
        keep = torch.isfinite(nll) & (nll < 1e29)
        torch.where(keep, nll, torch.zeros_like(nll)).sum().backward()
        grads.append(x.grad)
        values.append(torch.where(keep, nll, torch.zeros_like(nll)))
    torch.testing.assert_close(values[0], values[1], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(grads[0], grads[1], rtol=2e-4, atol=2e-5)
    assert not grads[0][3].any()                       # 12 labels in 3 frames


GRAD_RTOL = 1e-4  # kernel vs plain backward, of max |ref| per tensor: summation order


def _grad_close(got, want, names, floors=None):
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        tol = GRAD_RTOL * float(w.abs().max()) + 1e-7 + (floors[i] if floors else 0.0)
        err = float((g - w).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"


def _seed(hopper, value=1234):
    return torch.tensor([value], dtype=torch.int64, device=hopper)


@pytest.mark.gpu
def test_attention_wrappers_raise_under_autograd(hopper):
    """A gradient now arrives through each wrapper on the card and equals the
    plain version's (autograd through ``*_reference``)."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32)).to(hopper)
               for _ in range(3))
    kvb = torch.zeros(1, 1, 256, device=hopper)
    bias3 = torch.zeros(1, 256, 256, device=hopper)
    p = torch.from_numpy(rng.randn(2, 511, 64).astype(np.float32)).to(hopper)
    bias4 = bias3[:, None].contiguous()
    g = torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32)).to(hopper)
    cases = {
        "masked": (attention.masked_attention, attention.masked_attention_reference,
                   (q, k, v), (kvb,)),
        "bias": (attention.bias_attention, attention.bias_attention_reference,
                 (q, k, v), (bias3,)),
        "relpos": (attention.relpos_attention, attention.relpos_attention_reference,
                   (q, q * 0.5, k, v, p), (bias4,)),
    }
    for name, (fn, ref, diff, const) in cases.items():
        grads = []
        for f in (fn, ref):
            xs = [x.clone().requires_grad_() for x in diff]
            out = f(*xs, *const, 0.125)
            assert out.grad_fn is not None
            grads.append(torch.autograd.grad(out, xs, g))
        _grad_close(grads[0], grads[1], [f"{name}[{i}]" for i in range(len(diff))])
    with torch.no_grad():
        attention.masked_attention(q.requires_grad_(), q, q, kvb, 0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,rate", [(2, 3, 130, 70, 0.1), (1, 1, 64, 64, 0.5),
                                            (1, 2, 1280, 1280, 0.1), (2, 2, 5, 3, 0.9)])
def test_kernel_mask_equals_the_plain_mask(hopper, b, h, tq, tk, rate):
    """The mask the kernels' device functions draw is ``dropout_keep_reference``
    bit for bit, follows the seed, and keeps 1 - rate of the elements (3 sigma)."""
    seed = _seed(hopper, 77)
    got = attention.dropout_keep(seed, b, h, tq, tk, rate)
    want = attention.dropout_keep_reference(seed, b, h, tq, tk, rate)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert torch.equal(got.cpu(), attention.dropout_keep_reference(77, b, h, tq, tk, rate))
    n = got.numel()
    if n > 1000:
        assert not torch.equal(got, attention.dropout_keep(_seed(hopper, 78), b, h, tq,
                                                           tk, rate))
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(float(got.float().mean()) - (1 - rate)) < 3 * sigma


def _run_fwd_bwd(fn, bwd, ref, ref_bwd, diff, const, g, scale, rate, seed, keep,
                 floors=None):
    """The wrapper's forward and backward (through autograd) against the plain
    forward and the plain backward under the same keep mask, which must be the
    mask the kernels draw; ``floors`` adds an absolute term to each gradient's
    tolerance."""
    if keep is not None:
        assert torch.equal(attention.dropout_keep(seed, *keep.shape, rate), keep)
    before = (fn.launches, bwd.launches, attention.mask_draws,
              attention.dropout_keep.launches)
    xs = [x.clone().requires_grad_() for x in diff]
    out = fn(*xs, *const, scale, rate, seed)
    grads = torch.autograd.grad(out, xs, g)
    torch.cuda.synchronize()
    drew = 2 if rate > 0 else 0
    assert (fn.launches, bwd.launches, attention.mask_draws,
            attention.dropout_keep.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + drew, before[3])
    want = ref(*diff, *const, scale, keep, rate)
    tol = GRAD_RTOL * float(want.abs().max())
    assert float((out - want).abs().max()) <= tol
    want_grads = ref_bwd(*diff, *const, g, scale, keep, rate)
    _grad_close(grads, want_grads, [f"d{i}" for i in range(len(diff))], floors)
    again = torch.autograd.grad(fn(*xs, *const, scale, rate, seed), xs, g)
    for a, c in zip(grads, again):
        assert torch.equal(a, c)                       # no atomics: bit for bit
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,t,d,n_valid", [(8, 8, 1280, 64, None), (2, 2, 320, 24, [300, 320]),
                                             (1, 2, 128, 200, [128]), (1, 1, 64, 256, [60]),
                                             (1, 2, 192, 8, [192])])
def test_masked_attention_backward_matches_plain_version(hopper, b, h, t, d, n_valid, rate):
    n_valid = [1200] * b if n_valid is None else n_valid
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(b, h, t, d, seed=t + d, n_valid=n_valid))
    g = torch.from_numpy(np.random.RandomState(1).randn(b, h, t, d).astype(np.float32)
                         ).to(hopper)
    seed = _seed(hopper) if rate > 0 else None
    keep = attention.dropout_keep_reference(seed, b, h, t, t, rate) if rate > 0 else None
    _run_fwd_bwd(attention.masked_attention, attention.masked_attention_backward,
                 attention.masked_attention_reference,
                 attention.masked_attention_backward_reference, (q, k, v), (kvb,), g,
                 d ** -0.5, rate, seed, keep)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,d", [(8, 1200, 48, 64), (2, 70, 130, 16),
                                       (1, 100, 3, 256), (1, 600, 24, 200)])
def test_bias_attention_backward_matches_plain_version(hopper, b, tq, tk, d, rate):
    q, k, v, bias = (torch.from_numpy(a).to(hopper)
                     for a in _bias_inputs(b, 8, tq, tk, d, seed=tq + tk))
    g = torch.from_numpy(np.random.RandomState(2).randn(b, 8, tq, d).astype(np.float32)
                         ).to(hopper)
    seed = _seed(hopper) if rate > 0 else None
    keep = attention.dropout_keep_reference(seed, b, 8, tq, tk, rate) if rate > 0 else None
    _run_fwd_bwd(attention.bias_attention, attention.bias_attention_backward,
                 attention.bias_attention_reference,
                 attention.bias_attention_backward_reference, (q, k, v), (bias,), g,
                 d ** -0.5, rate, seed, keep)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,bias_heads,extra_rows,first_valid", [
    (8, 256, 64, 1, 0, 216), (1, 512, 64, 4, 0, 472), (2, 128, 24, 1, 5, 88),
    (1, 128, 112, 1, 0, 88), (1, 128, 224, 4, 0, 88), (1, 64, 256, 1, 0, 24),
    (1, 64, 8, 1, 0, 24), (2, 128, 8, 4, 0, 88), (2, 128, 64, 4, 0, 88),
    (2, 128, 128, 1, 0, 88), (2, 128, 128, 4, 0, 88), (2, 128, 256, 4, 0, 88),
    (2, 384, 64, 1, 0, 300)])
def test_relpos_attention_backward_matches_plain_version(hopper, b, t, d, bias_heads,
                                                         extra_rows, first_valid, rate):
    """B2 (one fused pass on the tensor cores, ordered partial sums) at the
    encoder's train shape and at both of its tile sizes (32 rows up to
    D = 136, 16 above), the bias per batch row or per head, a table longer
    than 2T-1 (its extra rows get a zero gradient), and a first batch row with
    ``first_valid`` keys (chunk 8: wholly masked rows past them)."""
    qu, qv, k, v, p, bias = (torch.from_numpy(a).to(hopper) for a in _relpos_inputs(
        b, 4, t, d, seed=t + d, n_valid=[first_valid] + [t] * (b - 1), chunk=8,
        bias_heads=bias_heads))
    if extra_rows:
        p = torch.cat([p, torch.ones(4, extra_rows, d, device=hopper)], dim=1).contiguous()
    g = torch.from_numpy(np.random.RandomState(3).randn(b, 4, t, d).astype(np.float32)
                         ).to(hopper)
    seed = _seed(hopper) if rate > 0 else None
    keep = attention.dropout_keep_reference(seed, b, 4, t, t, rate) if rate > 0 else None
    _run_fwd_bwd(attention.relpos_attention, attention.relpos_attention_backward,
                 attention.relpos_attention_reference,
                 attention.relpos_attention_backward_reference, (qu, qv, k, v, p),
                 (bias,), g, d ** -0.5, rate, seed, keep)


@pytest.mark.gpu
def test_backward_wrappers_raise_instead_of_falling_back(hopper):
    q = torch.zeros(1, 2, 128, 64, device=hopper)
    kvb = torch.zeros(1, 1, 128, device=hopper)
    stats = torch.zeros(1, 2, 128, 2, device=hopper)
    with pytest.raises(ValueError, match="row statistics"):
        attention.masked_attention_backward(q, q, q, kvb, q, q, None, None, 0.125)
    with pytest.raises(ValueError, match="seed"):
        attention.masked_attention_backward(q, q, q, kvb, q, q, stats, None, 0.125, 0.1)
    with pytest.raises(ValueError, match="seed"):          # a seed on the host
        attention.masked_attention(q, q, q, kvb, 0.125, 0.1, torch.tensor([3]))
    with pytest.raises(ValueError, match="rate"):
        attention.bias_attention(q, q, q, torch.zeros(1, 128, 128, device=hopper), 0.125,
                                 1.0, _seed(hopper))


@pytest.mark.gpu
def test_kernel_train_step_on_the_card_matches_the_cpu(hopper):
    """One tiny train step with the kernel route on (T_enc 256, unit T 600),
    attention dropout 0.1 drawn in the kernels from fixed seeds and every other
    dropout 0, on the card (kernels) and on the CPU (plain versions): the same
    losses and gradients, and 2/1/1 forward and backward launches."""
    from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
    from streamspeech_tpu_torch.models.layers import RelPosMultiHeadAttention
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.train import trainer
    from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
    from streamspeech_tpu_torch.weights import random_init_

    cfg = tiny_config(vocab_text=512, upsample=25)
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = 0.0
    nb = synthetic_batch(cfg, batch=2, frames=1024, mt_len=24, units_len=120, text_len=16)
    wrappers = (attention.relpos_attention, attention.masked_attention,
                attention.bias_attention, attention.relpos_attention_backward,
                attention.masked_attention_backward, attention.bias_attention_backward)
    real_draw = attention.draw_seed
    runs = {}
    try:
        for device in ("cpu", hopper):
            model = random_init_(StreamSpeechModel(cfg), 0).to(device)
            for name, m in model.named_modules():
                if isinstance(m, RelPosMultiHeadAttention) or name.startswith(
                        "unit_decoder.") and hasattr(m, "kernel_train"):
                    m.dropout = 0.1
            calls = iter(range(100, 200))
            attention.draw_seed = lambda gen, dev: torch.tensor(    # noqa: E731
                [next(calls)], dtype=torch.int64, device=dev)
            tx = trainer.make_optimizer(OptimizationConfig(update_freq=1))
            step = trainer.make_train_step(model, tx, cfg.unit_decoder.vocab_size - 1,
                                           kernel_attention=True)
            before = [f.launches for f in wrappers]
            _, metrics = step(trainer.TrainState.create(model, tx),
                              batch_to_tensors(nb, device=device),
                              torch.Generator(device=device).manual_seed(0), 8, 8)
            runs[str(device)] = (float(metrics["loss"]),
                                 {n: p.grad.cpu() for n, p in model.named_parameters()},
                                 [f.launches - c for f, c in zip(wrappers, before)])
    finally:
        attention.draw_seed = real_draw
    (ref_loss, ref_grads, cpu_launches), (loss, grads, launches) = runs["cpu"], runs[str(hopper)]
    assert cpu_launches == [0] * 6 and launches == [2, 1, 1, 2, 1, 1]
    assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
    for name, want in ref_grads.items():
        tol = 1e-3 * float(want.abs().max()) + 1e-7
        assert float((grads[name] - want).abs().max()) <= tol, name


def _bias_bwd_inputs(b, h, tq, tk, d, seed):
    """``_bias_inputs`` with at least one valid key in every batch row."""
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    n_valid = np.array([tk] + [max(1, tk - 5)] * (b - 1))
    allowed = (np.arange(tk)[None, None, :] < np.minimum(
        np.arange(tq)[None, :, None] // 25 + 1, tk)) & \
        (np.arange(tk)[None, None, :] < n_valid[:, None, None])
    bias = np.where(allowed, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias, g


# (TQ, TK) of the B6 form tests, TQ ragged; B = 2, H = 3
BIAS_FORM_SHAPES = [(331, 1), (331, 7), (331, 48), (50, 48), (331, 65), (331, 130)]
BIAS_FORM_HEAD_DIMS = [8, 24, 64, 128, 256]


@pytest.mark.gpu
def test_bias_backward_form_shapes_cover_every_form(hopper):
    """The shapes below reach, by the library's own choice of form, both the
    fused pass and the two-pass form at every head dim, and the fused pass
    with one query-tile group and with several."""
    groups = {d: {attention.bias_backward_scratch(2, 3, tq, tk, d)[0]
                  for tq, tk in BIAS_FORM_SHAPES} for d in BIAS_FORM_HEAD_DIMS}
    assert all(0 in g and max(g) > 0 for g in groups.values()), groups
    every = set().union(*groups.values())
    assert 1 in every and max(every) > 1, groups


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", BIAS_FORM_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk", BIAS_FORM_SHAPES)
def test_bias_backward_fused_and_two_pass_forms(hopper, tq, tk, d, rate):
    """B6 on the form its library picks for the shape (the fused pass while
    the keys fit one resident tile, with G query-tile groups; else two
    passes), TQ ragged; bit-identical twice."""
    b, h = 2, 3
    q, k, v, bias, g = (torch.from_numpy(a).to(hopper)
                        for a in _bias_bwd_inputs(b, h, tq, tk, d, seed=tq + tk + d))
    seed = _seed(hopper, 4321) if rate > 0 else None
    keep = attention.dropout_keep_reference(seed, b, h, tq, tk, rate) if rate > 0 else None
    floors = None
    if tk == 1:
        # a softmax over one key is constant: the plain ds, dq and dK are 0
        # exactly, the kernel's p = 1 + O(eps) (s recomputed in another order
        # than the forward's statistics) leaves ds = O(eps |dp|). Held to what
        # ds within 1e-4 scale max|dp| gives: dq = ds K, dK = sum_i ds_i q_i
        ds_tol = GRAD_RTOL * d ** -0.5 * float(torch.einsum("bhsd,bhtd->bhst", g, v)
                                               .abs().max()) / (1.0 - rate)
        floors = [ds_tol * float(k.abs().max()), ds_tol * float(q.abs().max()) * tq, 0.0]
    _run_fwd_bwd(attention.bias_attention, attention.bias_attention_backward,
                 attention.bias_attention_reference,
                 attention.bias_attention_backward_reference, (q, k, v), (bias,), g,
                 d ** -0.5, rate, seed, keep, floors)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [8, 40, 128, 256])
@pytest.mark.parametrize("t", [64, 1280])
def test_causal_backward_tensor_core_forms(hopper, t, d, rate):
    """B4 at one tile and at the unit decoder's train length, at both tile
    sizes (64 rows up to D = 120, 32 above); bit-identical twice."""
    b, h = (1, 2) if t > 64 else (2, 3)
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(b, h, t, d, seed=t + d, n_valid=[t - 17] * b))
    g = torch.from_numpy(np.random.RandomState(5).randn(b, h, t, d).astype(np.float32)
                         ).to(hopper)
    seed = _seed(hopper, 99) if rate > 0 else None
    keep = attention.dropout_keep_reference(seed, b, h, t, t, rate) if rate > 0 else None
    _run_fwd_bwd(attention.masked_attention, attention.masked_attention_backward,
                 attention.masked_attention_reference,
                 attention.masked_attention_backward_reference, (q, k, v), (kvb,), g,
                 d ** -0.5, rate, seed, keep)


HEAD_DIMS = list(range(8, 257, 8))
# (T_pad, valid keys): the unit decoder's serving buckets and the forward's 24 x 25
CAUSAL_FORWARD_SHAPES = [(512, 400), (896, 800), (1664, 1600), (3200, 3200), (640, 600)]


def _causal_stats(q, k, kvb, scale):
    """The row max and 1 / sum of the causal scores, the backward's residual."""
    t = q.shape[2]
    i = torch.arange(t, device=q.device)
    s = torch.einsum("bhsd,bhtd->bhst", q, k) * scale + kvb[:, :, None, :] \
        + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF).float()
    mx = s.max(-1).values
    return torch.stack([mx, 1.0 / torch.exp(s - mx[..., None]).sum(-1)], -1)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t_pad,n_valid", CAUSAL_FORWARD_SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_causal_forward_tensor_core_forms(hopper, d, t_pad, n_valid, rate):
    """B3 (3xTF32 on the tensor cores) at every head dim it takes, at the
    serving buckets and the forward's length, ragged keys: within 1e-5 of the
    plain version without dropout, its training form within 1e-4 max|ref|
    under the plain mask with it, the row statistics the plain ones, the mask
    the one ``dropout_keep_reference`` draws, two calls bit-identical."""
    b, h = 1, 2
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(b, h, t_pad, d, seed=t_pad + d, n_valid=[n_valid]))
    scale = d ** -0.5
    seed = _seed(hopper, 31) if rate > 0 else None
    out, stats = attention.masked_attention_forward(q, k, v, kvb, scale, rate, seed, True)
    again, stats_again = attention.masked_attention_forward(q, k, v, kvb, scale, rate,
                                                            seed, True)
    assert torch.equal(out, again) and torch.equal(stats, stats_again)
    keep = None
    if rate > 0:
        keep = attention.dropout_keep_reference(seed, b, h, t_pad, t_pad, rate)
        assert torch.equal(attention.dropout_keep(seed, b, h, t_pad, t_pad, rate), keep)
    want = attention.masked_attention_reference(q, k, v, kvb, scale, keep, rate)
    tol = ATOL if rate == 0 else GRAD_RTOL * float(want.abs().max())
    assert float((out - want).abs().max()) <= tol
    want_stats = _causal_stats(q, k, kvb, scale)
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-6)



def _relpos_stats(qu, qv, k, p, bias, scale):
    """The row max and 1 / sum of the rel-pos scores, the backward's residual."""
    t = qu.shape[2]
    s = torch.einsum("bhsd,bhtd->bhst", qu, k) + torch.gather(
        torch.einsum("bhsd,hrd->bhsr", qv, p), -1,
        attention._relpos_rows(t, qu.device)[None, None].expand(*qu.shape[:2], t, t))
    s = s * scale + bias
    mx = s.max(-1).values
    return torch.stack([mx, 1.0 / torch.exp(s - mx[..., None]).sum(-1)], -1)


def _forward_form_check(fwd, ref, args, const, keep_shape, scale, rate, seed, want_stats):
    """A forward kernel's training form: within 1e-5 of the plain version
    without dropout and 1e-4 max|ref| under the plain mask with it, the row
    statistics the plain ones, the mask the one ``dropout_keep_reference``
    draws, one launch, two calls bit-identical."""
    out, stats = fwd(*args, *const, scale, rate, seed, True)
    again, stats_again = fwd(*args, *const, scale, rate, seed, True)
    assert torch.equal(out, again) and torch.equal(stats, stats_again)
    keep = None
    if rate > 0:
        keep = attention.dropout_keep_reference(seed, *keep_shape, rate)
        assert torch.equal(attention.dropout_keep(seed, *keep_shape, rate), keep)
    want = ref(*args, *const, scale, keep, rate)
    tol = ATOL if rate == 0 else GRAD_RTOL * float(want.abs().max())
    assert float((out - want).abs().max()) <= tol
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-6)


# (B, T): both of the launcher's cuts (1 x 8 below two row groups an SM, 4 x 4
# above) at one key tile and at the longest, each head dim's fallback cut
RELPOS_FORWARD_CUTS = [(1, 64), (17, 64), (1, 512), (3, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t", RELPOS_FORWARD_CUTS)
@pytest.mark.parametrize("d", [8, 64, 136, 144, 256])
def test_relpos_forward_tensor_core_forms(hopper, d, b, t, rate):
    """B1 (3xTF32 on the tensor cores, key slices merged) at both of its cuts
    and the head dims where the cut shrinks to fit, the bias per head, the
    first batch row with 40 keys masked (wholly masked rows past them)."""
    qu, qv, k, v, p, bias = (torch.from_numpy(a).to(hopper) for a in _relpos_inputs(
        b, 4, t, d, seed=t + d + b, n_valid=[t - 40] + [t] * (b - 1), chunk=8,
        bias_heads=4))
    scale = d ** -0.5
    before = attention.relpos_attention.launches
    _forward_form_check(attention.relpos_attention_forward,
                        attention.relpos_attention_reference, (qu, qv, k, v, p), (bias,),
                        (b, 4, t, t), scale, rate, _seed(hopper, 41) if rate > 0 else None,
                        _relpos_stats(qu, qv, k, p, bias, scale))
    assert attention.relpos_attention.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tk", [1, 8, 30, 64, 65, 130])
@pytest.mark.parametrize("d", [8, 64, 256])
def test_bias_forward_tensor_core_forms(hopper, d, tk, rate):
    """B5 (3xTF32, key tiles of TK rounded up to 8) at one key, one slab, a
    ragged row of 30 (bias rows by 4-byte copies), one whole tile, one past it
    and two past it, TQ = 70 (not a multiple of the query tile)."""
    b, h, tq = 2, 3, 70
    q, k, v, bias = (torch.from_numpy(a).to(hopper)
                     for a in _bias_inputs(b, h, tq, tk, d, seed=tk + d))
    scale = d ** -0.5
    s = torch.einsum("bhsd,bhtd->bhst", q, k) * scale + bias[:, None]
    mx = s.max(-1).values
    want_stats = torch.stack([mx, 1.0 / torch.exp(s - mx[..., None]).sum(-1)], -1)
    before = attention.bias_attention.launches
    _forward_form_check(attention.bias_attention_forward, attention.bias_attention_reference,
                        (q, k, v), (bias,), (b, h, tq, tk), scale, rate,
                        _seed(hopper, 43) if rate > 0 else None, want_stats)
    assert attention.bias_attention.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("last_blank", [False, True])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("t", [64, 65, 256])
@pytest.mark.parametrize("v", [512, 513, 6000, 6001])
def test_not_blank_one_pass_at_even_and_odd_widths(hopper, v, t, b, last_blank):
    """B7's one pass (16-byte loads where V % 4 == 0, 4-byte otherwise; one to
    eight warps a row) against its plain version, one launch a call."""
    from streamspeech_tpu_torch.kernels import policy

    blank = v - 1 if last_blank else 0
    logits = torch.from_numpy(np.random.RandomState(v + t + b).randn(b, t, v).astype(
        np.float32) * 4).to(hopper)
    before = policy.not_blank_probs.launches
    got = policy.not_blank_probs(logits, blank)
    torch.cuda.synchronize()
    assert policy.not_blank_probs.launches == before + 1
    torch.testing.assert_close(got, policy.not_blank_probs_reference(logits, blank),
                               atol=1e-6, rtol=0)


# a rate on a step of the kernels' integer threshold (k·2⁻²⁴, exact in float32)
# and its float32 neighbours, whose thresholds differ by one step above it
STEP_RATE = 1677722 * 2.0 ** -24
STEP_RATES = [float(np.nextafter(np.float32(STEP_RATE), np.float32(0))), STEP_RATE,
              float(np.nextafter(np.float32(STEP_RATE), np.float32(1))),
              float(np.nextafter(np.float32(0.1), np.float32(0))), 0.1,
              float(np.nextafter(np.float32(0.1), np.float32(1)))]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", STEP_RATES)
def test_mask_next_to_a_threshold_step(hopper, rate):
    """The kernels' mask (their device functions, written out) is the plain
    mask bit for bit at rates next to a step of the integer threshold, and the
    causal forward's training form holds against the plain one under it."""
    seed = _seed(hopper, 2024)
    for shape in [(2, 3, 130, 70), (1, 2, 1280, 1280)]:
        assert torch.equal(attention.dropout_keep(seed, *shape, rate),
                           attention.dropout_keep_reference(seed, *shape, rate))
    b, h, t, d = 1, 2, 256, 64
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(b, h, t, d, seed=7, n_valid=[250]))
    keep = attention.dropout_keep_reference(seed, b, h, t, t, rate)
    out, _ = attention.masked_attention_forward(q, k, v, kvb, 0.125, rate, seed, True)
    want = attention.masked_attention_reference(q, k, v, kvb, 0.125, keep, rate)
    assert float((out - want).abs().max()) <= GRAD_RTOL * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["relpos", "masked", "bias"])
def test_attention_kernels_at_rate_one_tenth_bit_identical_twice(hopper, family):
    """Each forward (B1, B3, B5) and backward (B2, B4, B6) at dropout 0.1, at
    the kernel train route's shapes, gives the same bits on a second call."""
    rng = np.random.RandomState(3)
    if family == "relpos":
        diff = tuple(torch.from_numpy(a).to(hopper) for a in _relpos_inputs(
            8, 4, 256, 64, seed=3, n_valid=[256] * 7 + [200], chunk=8))
        diff, const, shape = diff[:5], diff[5:], (8, 4, 256, 64)
    elif family == "masked":
        q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                        for a in _inputs(8, 8, 1280, 64, seed=3, n_valid=[1200] * 8))
        diff, const, shape = (q, k, v), (kvb,), (8, 8, 1280, 64)
    else:
        q, k, v, bias, _ = (torch.from_numpy(a).to(hopper)
                            for a in _bias_bwd_inputs(8, 8, 1200, 48, 64, seed=3))
        diff, const, shape = (q, k, v), (bias,), (8, 8, 1200, 64)
    fwd = getattr(attention, f"{family}_attention_forward")
    bwd = getattr(attention, f"{family}_attention_backward")
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(hopper)
    seed = _seed(hopper, 555)
    runs = []
    for _ in range(2):
        out, stats = fwd(*diff, *const, 0.125, 0.1, seed, True)
        runs.append((out, stats, *bwd(*diff, *const, g, out, stats, seed, 0.125, 0.1)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [64, 128])  # D = T: each kernel's copy for dropout, and D > 64's
@pytest.mark.parametrize("family", ["relpos", "masked", "bias"])
def test_kernels_keep_bits_equal_the_plain_mask(hopper, family, t):
    """Each kernel's own keep bits, element by element, as drawn on its
    accumulator fragments. With v the identity a forward (B1, B3, B5) gives
    out[i, j] = p[i, j] keep[i, j] / (1 - rate); with g the identity a backward
    (B2, B4, B6) gives dV[j, i] the same. So the elements that are not 0 are
    the kept ones among those the attention mask allows, which
    ``dropout_keep_reference`` gives, at rate 0.1."""
    b, h, d, rate, scale = 2, 3, t, 0.1, t ** -0.5
    eye = torch.eye(t, device=hopper).expand(b, h, t, t).contiguous()
    if family == "relpos":
        qu, qv, k, _, p, bias = (torch.from_numpy(a).to(hopper) for a in _relpos_inputs(
            b, h, t, d, seed=t, n_valid=[t - 8, t], chunk=8))
        diff, const, v_at = (qu, qv, k, eye, p), (bias,), 3
    elif family == "masked":
        q, k, _, kvb = (torch.from_numpy(a).to(hopper)
                        for a in _inputs(b, h, t, d, seed=t, n_valid=[t - 8, t]))
        diff, const, v_at = (q, k, eye), (kvb,), 2
    else:
        rng = np.random.RandomState(t)
        q, k = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(hopper)
                for _ in range(2))
        diff, const, v_at = (q, k, eye), (torch.zeros(b, t, t, device=hopper),), 2
    fwd = getattr(attention, f"{family}_attention_forward")
    bwd = getattr(attention, f"{family}_attention_backward")
    ref = getattr(attention, f"{family}_attention_reference")
    seed = _seed(hopper, 99 + t)
    allowed = ref(*diff, *const, scale, None, 0.0) != 0  # p itself, 0 where masked
    want = attention.dropout_keep_reference(seed, b, h, t, t, rate) & allowed
    out, stats = fwd(*diff, *const, scale, rate, seed, True)
    dv = bwd(*diff, *const, eye, out, stats, seed, scale, rate)[v_at]
    torch.cuda.synchronize()
    assert 0.3 < float(allowed.float().mean()) and 0.8 < float(want.sum() / allowed.sum()) < 0.99
    assert torch.equal(out != 0, want)
    assert torch.equal(dv.transpose(-1, -2) != 0, want)


# The bf16 forms of B3, B5 (``csrc/attention_bf16.cuh``) and B7. The kernel
# rounds each un-normalised probability to bf16 and divides at the end; the
# plain version normalises, then rounds (JAX's order). Each probability p_j is
# rounded once on each side (at most 2^-8 p_j: bf16 keeps 8 significant bits),
# so each output element differs by at most 2^-7 sum_j p_j |v_j|, plus the
# fp32 summation order; p are the plain version's fp32 probabilities, which
# ``reference`` on |v| in float32 sums without rounding.
def _assert_within_bf16_bound(got, want, reference, q, k, v, bias, scale):
    bound = 2.0 ** -7 * reference(q, k, v.float().abs(), bias, scale) + 1e-5
    share = float(((got - want).abs() / bound).max())
    assert share <= 1.0, f"an element reached {share} of its bound"


def _bf16(*arrays, device):
    return [torch.from_numpy(a).to(device=device, dtype=torch.bfloat16) for a in arrays]


# every head dim at one tile and at five, ragged; the serving buckets at D = 64
BF16_CAUSAL_CASES = [(d, t_pad, n_valid) for d in range(8, 257, 8)
                     for t_pad, n_valid in ((64, 40), (320, 300))] + \
    [(64, 512, 400), (64, 3200, 3200)] + \
    [(64, 896, 800), (64, 1664, 1600), (64, 640, 600)]  # the other serving buckets, the forward's


@pytest.mark.gpu
@pytest.mark.parametrize("d,t_pad,n_valid", BF16_CAUSAL_CASES)
def test_bf16_causal_kernel_matches_plain_version(hopper, d, t_pad, n_valid):
    q, k, v, kvb = _inputs(2, 2, t_pad, d, seed=t_pad + d, n_valid=[n_valid, t_pad])
    q, k, v = _bf16(q, k, v, device=hopper)
    kvb = torch.from_numpy(kvb).to(hopper)
    before = (attention.masked_attention.launches, attention.masked_attention.bf16_launches)
    with torch.no_grad():
        got = attention.masked_attention(q, k, v, kvb, d ** -0.5)
    torch.cuda.synchronize()
    assert (attention.masked_attention.launches,
            attention.masked_attention.bf16_launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.float32
    want = attention.masked_attention_reference(q, k, v, kvb, d ** -0.5)
    _assert_within_bf16_bound(got, want, attention.masked_attention_reference,
                              q, k, v, kvb, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("tk", [1, 8, 24, 30, 48, 64, 65, 130])
@pytest.mark.parametrize("d", [8, 24, 64, 136, 256])
def test_bf16_bias_kernel_matches_plain_version(hopper, d, tk):
    """One key, one 8-key tile, the unit decoder's 24 and 48, a ragged row of
    30 (bias rows by 4-byte copies), one whole tile, one past it, two past it;
    TQ = 70 (not a multiple of the query tile)."""
    q, k, v, bias = _bias_inputs(2, 3, 70, tk, d, seed=tk + 7 * d)
    q, k, v = _bf16(q, k, v, device=hopper)
    bias = torch.from_numpy(bias).to(hopper)
    before = (attention.bias_attention.launches, attention.bias_attention.bf16_launches)
    with torch.no_grad():
        got = attention.bias_attention(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert (attention.bias_attention.launches,
            attention.bias_attention.bf16_launches) == (before[0], before[1] + 1)
    want = attention.bias_attention_reference(q, k, v, bias, d ** -0.5)
    _assert_within_bf16_bound(got, want, attention.bias_attention_reference,
                              q, k, v, bias, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,v,blank", [(1, 256, 6000, 0), (8, 256, 6000, 0),
                                         (3, 65, 513, 512), (2, 64, 6004, 0),
                                         (1, 70, 6001, 3)])
def test_bf16_not_blank_kernel_matches_plain_version(hopper, b, t, v, blank):
    """16-byte loads of 8 logits where V % 8 == 0, single logits otherwise."""
    from streamspeech_tpu_torch.kernels import policy

    logits = torch.from_numpy(np.random.RandomState(v + t).randn(b, t, v).astype(
        np.float32) * 4).to(hopper, torch.bfloat16)
    before = (policy.not_blank_probs.launches, policy.not_blank_probs.bf16_launches)
    got = policy.not_blank_probs(logits, blank)
    torch.cuda.synchronize()
    assert (policy.not_blank_probs.launches,
            policy.not_blank_probs.bf16_launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, policy.not_blank_probs_reference(logits, blank),
                               atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_bf16_wrappers_raise_instead_of_falling_back(hopper):
    z = torch.zeros(1, 2, 64, 64, device=hopper, dtype=torch.bfloat16)
    kvb = torch.zeros(1, 1, 64, device=hopper)
    bias = torch.zeros(1, 64, 64, device=hopper)
    with pytest.raises(ValueError):                     # k not bf16 like q
        attention.masked_attention(z, z.float(), z, kvb, 0.125)
    with pytest.raises(ValueError):                     # the bias stays fp32
        attention.bias_attention(z, z, z, bias.bfloat16(), 0.125)
    with pytest.raises(ValueError):                     # float16 has no instance
        attention.masked_attention(z.half(), z.half(), z.half(), kvb, 0.125)
    out, stats = attention.masked_attention_forward(z, z, z, kvb, 0.125, 0.1, _seed(hopper),
                                                    True)
    with pytest.raises(ValueError):                     # g is fp32, the output's dtype
        attention.masked_attention_backward(z, z, z, kvb, out.bfloat16(), out, stats,
                                            _seed(hopper), 0.125, 0.1)
    with pytest.raises(ValueError):                     # the forward's statistics
        attention.bias_attention_backward(z, z, z, bias, out, out, None, None, 0.125)
    with pytest.raises(ValueError):                     # rel-pos stays fp32
        attention.relpos_attention(z, z, z, z, torch.zeros(2, 127, 64, device=hopper,
                                                           dtype=torch.bfloat16),
                                   torch.zeros(1, 1, 64, 64, device=hopper), 0.125)


@pytest.mark.gpu
def test_bf16_model_routes_launch_the_bf16_forms(hopper):
    """A bf16 model's unit-decoder attention and CTC mask at the kernel gates
    (T >= 256, S >= 512, V >= 512) launch the bf16 forms and no fp32 one."""
    from streamspeech_tpu_torch.config import tiny_config
    from streamspeech_tpu_torch.kernels import policy
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.weights import random_init_

    cfg = tiny_config(vocab_text=512, upsample=25)
    model = random_init_(StreamSpeechModel(cfg, dtype=torch.bfloat16), 0).eval().to(hopper)
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randn(1, 1024, 80).astype(np.float32)).to(hopper)
    mt = torch.from_numpy(rng.randint(4, 512, size=(1, 24))).to(hopper)
    mt[:, 0] = 2
    counts = (attention.masked_attention, attention.bias_attention, policy.not_blank_probs)
    before = [(f.launches, f.bf16_launches) for f in counts]
    with torch.no_grad():
        out = model(src, torch.tensor([1024], device=hopper), mt, n2=1)
    torch.cuda.synchronize()
    after = [(f.launches, f.bf16_launches) for f in counts]
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == \
        [(0, 1), (0, 1), (0, 2)]
    assert out["unit_logits"].dtype == torch.bfloat16
    assert torch.isfinite(out["unit_logits"].float()).all()


# The bf16 training forms of B3 and B5 (dropout, row statistics) and the bf16
# backwards B4 and B6 (``csrc/attention_bwd_bf16.cuh``) against their plain
# bf16 versions under the same mask.
def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits); 0 at 0."""
    m, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(m), e - 8), torch.zeros_like(m))


def _bf16_grad_bounds(family, q, k, v, bias, g, scale, keep, rate):
    """Each gradient element's bound against the plain bf16 backward: one bf16
    ulp (the two fp32 results may round apart across a bf16 boundary) plus
    2^-12 of the magnitudes of its terms (the kernel's split products err by
    ~2^-16 of them, its fp32 sums in another order by less). The terms of dq
    and dK: ds with dp's own terms, p (|g||v|ᵀ kf + Σ p |g||v|ᵀ kf) scale
    (dp from g split in two bf16 parts errs by ~2^-17 of Σ_d |g_d v_jd|, and
    p (dp - delta) may cancel far below that), times |K| or |q|; of dV:
    p kf |g|."""
    probs = (attention._masked_probs if family == "masked" else attention._bias_probs)(
        q, k, bias, scale)
    kf = torch.ones_like(probs) if keep is None else keep.float() / (1.0 - rate)
    dp = torch.einsum("bhsd,bhtd->bhst", g.abs(), v.float().abs()) * kf
    ds = probs * (dp + (probs * dp).sum(-1, keepdim=True)) * scale
    return (torch.einsum("bhst,bhtd->bhsd", ds, k.float().abs()),
            torch.einsum("bhst,bhsd->bhtd", ds, q.float().abs()),
            torch.einsum("bhst,bhsd->bhtd", probs * kf, g.abs()))


def _assert_bf16_grads(got, want, terms):
    for name, a, w, t in zip(("dq", "dk", "dv"), got, want, terms):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        bound = torch.maximum(_bf16_ulp(a), _bf16_ulp(w)) + 2.0 ** -12 * t + 1e-30
        share = float(((a.float() - w.float()).abs() / bound).max())
        assert share <= 1.0, f"{name}: an element reached {share} of its bound"


# The bias route's keys on the path: the MT decoder's 48 padded to the 128 tile
# (zero K and V, a NEG_INF bias past the valid keys), as JAX pads them.
PATH_KEY_TILE, PATH_VALID_KEYS = 128, 48


def _bf16_family_inputs(family, b, h, tq, tk, d, seed, masked_row=False):
    """bf16 q, k, v, an fp32 g and the family's bias on the card: causal with
    the last 8 keys of row 0 invalid; bias the wait-k mask with key validity,
    and with ``masked_row`` row 1's query 0 wholly masked. A bias case at TK =
    PATH_KEY_TILE has the path's layout: PATH_VALID_KEYS keys, the rest
    padding."""
    if family == "masked":
        q, k, v, kvb = _inputs(b, h, tq, d, seed=seed, n_valid=[tq - 8] + [tq] * (b - 1))
        bias = kvb
    elif tk == PATH_KEY_TILE:
        q, k, v, bias = _bias_inputs(b, h, tq, PATH_VALID_KEYS, d, seed=seed)
        pad = tk - PATH_VALID_KEYS
        k, v = (np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (k, v))
        bias = np.pad(bias, ((0, 0), (0, 0), (0, pad)), constant_values=NEG_INF)
        if masked_row:
            bias[min(1, b - 1), 0] = NEG_INF
    else:
        q, k, v, bias = _bias_inputs(b, h, tq, tk, d, seed=seed)
        if masked_row:
            bias[min(1, b - 1), 0] = NEG_INF
    g = np.random.RandomState(seed + 1).randn(b, h, tq, d).astype(np.float32)
    q, k, v = _bf16(q, k, v, device=hopper_device())
    return q, k, v, torch.from_numpy(bias).to(q.device), torch.from_numpy(g).to(q.device)


def hopper_device():
    return torch.device("cuda", 0)


BF16_TRAIN_CASES = [("masked", 1, 2, 64, 64, d) for d in (8, 16, 24, 64, 72, 136, 256)] + \
    [("masked", 2, 2, 320, 320, d) for d in (16, 64, 256)] + \
    [("masked", 1, 2, 1280, 1280, 64)] + \
    [("bias", 2, 2, tq, tk, d) for tq, tk in ((70, 24), (1200, 48), (130, 65), (100, 130))
     for d in (8, 24, 64, 136, 256)] + \
    [("bias", 2, 2, 1200, PATH_KEY_TILE, 64)] + \
    [("bias", 9, 8, 130, 65, 64)]   # 72 heads: B6-bf16's one kernel without a cluster


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("family,b,h,tq,tk,d", BF16_TRAIN_CASES)
def test_bf16_training_forward_and_backward_match_plain_versions(hopper, family, b, h, tq,
                                                                 tk, d, rate):
    """The training forward (dropout, statistics) within the bf16 forward's
    bound under the same keep mask; the backward's dq, dK, dV (bf16) within
    ``_bf16_grad_bounds`` of the plain bf16 backward; a second backward equal
    bit for bit; each counted once on its bf16 counter."""
    q, k, v, bias, g = _bf16_family_inputs(family, b, h, tq, tk, d, seed=tq + tk + d,
                                           masked_row=True)
    scale = d ** -0.5
    seed = _seed(hopper, 700 + d)
    fwd = getattr(attention, f"{family}_attention_forward")
    bwd = getattr(attention, f"{family}_attention_backward")
    ref = getattr(attention, f"{family}_attention_reference")
    ref_bwd = getattr(attention, f"{family}_attention_backward_reference")
    public = getattr(attention, f"{family}_attention")
    keep = attention.dropout_keep_reference(seed, b, h, tq, tk, rate) if rate > 0 else None
    counts = (public.launches, public.bf16_launches, bwd.launches, bwd.bf16_launches)
    out, stats = fwd(q, k, v, bias, scale, rate, seed, True)
    grads = bwd(q, k, v, bias, g, out, stats, seed, scale, rate)
    again = bwd(q, k, v, bias, g, out, stats, seed, scale, rate)
    torch.cuda.synchronize()
    assert (public.launches, public.bf16_launches, bwd.launches, bwd.bf16_launches) == \
        (counts[0], counts[1] + 1, counts[2], counts[3] + 2)
    assert out.dtype == torch.float32 and stats.shape == (b, h, tq, 2)
    assert torch.isfinite(stats).all()
    want = ref(q, k, v, bias, scale, keep, rate)
    bound = 2.0 ** -7 * ref(q, k, v.float().abs(), bias, scale, keep, rate) + 1e-5
    assert float(((out - want).abs() / bound).max()) <= 1.0
    _assert_bf16_grads(grads, ref_bwd(q, k, v, bias, g, scale, keep, rate),
                       _bf16_grad_bounds(family, q, k, v, bias, g, scale, keep, rate))
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("family,b,tq,tk,kernels", [
    ("masked", 2, 1280, 1280, 2), ("bias", 2, 1200, PATH_KEY_TILE, 1), ("bias", 2, 130, 65, 1),
    ("bias", 2, 100, 130, 2)])
def test_bf16_backward_launches_the_cuda_kernels_its_form_states(hopper, family, b, tq, tk,
                                                                   kernels):
    """Counted by ``torch.profiler``: a B6-bf16 call at TK <= 128 (D 64)
    launches one CUDA kernel (the one-kernel form), B4-bf16 and B6-bf16 past
    128 keys two (the dQ pass, then the dK/dV pass), as
    ``bf16_backward_kernels`` states; no other device work."""
    d = 64
    q, k, v, bias, g = _bf16_family_inputs(family, b, 2, tq, tk, d, seed=3)
    seed = _seed(hopper, 5)
    out, stats = getattr(attention, f"{family}_attention_forward")(
        q, k, v, bias, 0.125, 0.1, seed, True)
    spec = attention._MASKED_BWD_BF16_KERNELS if family == "masked" else \
        attention._BIAS_BWD_BF16_KERNELS
    assert attention.bf16_backward_kernels(spec, b, 2, tq, tk, d) == kernels
    attention.backward_bf16(family, q, k, v, bias, g, stats, seed, 0.125, 0.1)  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        attention.backward_bf16(family, q, k, v, bias, g, stats, seed, 0.125, 0.1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == kernels, names
    want = ["fused_kernel"] if kernels == 1 else ["dq_kernel", "dkv_kernel"]
    assert all(w in n for w, n in zip(want, names)), names


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("family", ["masked", "bias"])
def test_bf16_backward_forms_delta_from_the_fp32_probabilities(hopper, family, rate):
    """delta, which the dQ pass writes for the dK/dV pass, is Σ_j p dp of the
    fp32 probabilities, within 2^-16 of its terms Σ_j p Σ_d |g_d v_jd| (g split
    in two bf16 parts is g to 2^-17). rowsum(g out), what the fp32 kernels
    take, is not: out came from probabilities rounded to bf16, and with V off
    zero (a common offset, as trained values have) it misses by far more than
    that bound, so this check fails a kernel that took it."""
    b, h, d = 2, 2, 64
    tq, tk = (640, 640) if family == "masked" else (1200, 48)
    q, k, v, bias, g = _bf16_family_inputs(family, b, h, tq, tk, d, seed=5)
    v = (v.float() + 4.0).bfloat16()
    seed = _seed(hopper, 99)
    out, stats = getattr(attention, f"{family}_attention_forward")(
        q, k, v, bias, 0.125, rate, seed, True)
    delta = attention.backward_bf16(family, q, k, v, bias, g, stats, seed, 0.125, rate)[3]
    probs = (attention._masked_probs if family == "masked" else attention._bias_probs)(
        q, k, bias, 0.125)
    kf = 1.0 if rate == 0 else attention.dropout_keep_reference(seed, b, h, tq, tk,
                                                                rate).float() / (1 - rate)
    dp = torch.einsum("bhsd,bhtd->bhst", g, v.float()) * kf
    true = (probs * dp).sum(-1)
    terms = torch.einsum("bhsd,bhtd->bhst", g.abs(), v.float().abs()) * kf
    tol = 2.0 ** -16 * (probs * terms).sum(-1) + 1e-6
    from_out = (g * out).sum(-1)
    assert float(((delta - true).abs() / tol).max()) <= 1.0
    assert float(((from_out - true).abs() / tol).max()) > 10.0


@pytest.mark.gpu
@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("family", ["masked", "bias"])
def test_bf16_kernels_keep_bits_equal_the_plain_mask(hopper, family, t):
    """As ``test_kernels_keep_bits_equal_the_plain_mask`` for the bf16 forms:
    with v the identity the training forward's out[i, j] is bf16(p kf)[i, j]
    / sum, with g the identity the backward's dV[j, i] is p kf, so the
    elements that are not 0 are the kept ones the mask allows."""
    b, h, d, rate, scale = 2, 3, t, 0.1, t ** -0.5
    q, k, _, bias, _ = _bf16_family_inputs(family, b, h, t, t, d, seed=t)
    if family == "bias":       # every key allowed, as the fp32 test's bias
        bias = torch.zeros(b, t, t, device=hopper)
    eye = torch.eye(t, device=hopper).expand(b, h, t, t).contiguous()
    seed = _seed(hopper, 77 + t)
    ref = getattr(attention, f"{family}_attention_reference")
    allowed = ref(q, k, eye.bfloat16(), bias, scale, None, 0.0) != 0
    want = attention.dropout_keep_reference(seed, b, h, t, t, rate) & allowed
    out, stats = getattr(attention, f"{family}_attention_forward")(
        q, k, eye.bfloat16(), bias, scale, rate, seed, True)
    dv = getattr(attention, f"{family}_attention_backward")(
        q, k, eye.bfloat16(), bias, eye, out, stats, seed, scale, rate)[2]
    torch.cuda.synchronize()
    assert 0.3 < float(allowed.float().mean()) and 0.8 < float(want.sum() / allowed.sum()) < 0.99
    assert torch.equal(out != 0, want)
    assert torch.equal(dv.transpose(-1, -2) != 0, want)


# The bf16 forwards' two forms (``attention.bf16_forward_form``): wgmma at D <=
# 64 (the bias form at TK <= 128), mma.sync elsewhere; one CUDA kernel a call.
BF16_FORWARD_FORMS = [("masked", 512, 64, "wgmma"), ("masked", 128, 72, "mma.sync"),
                      ("bias", PATH_KEY_TILE, 64, "wgmma"), ("bias", 24, 8, "wgmma"),
                      ("bias", 130, 64, "mma.sync"), ("bias", 48, 136, "mma.sync")]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("family,tk,d,form", BF16_FORWARD_FORMS)
def test_bf16_forward_launches_one_cuda_kernel_of_its_form(hopper, family, tk, d, form, rate):
    """Counted by ``torch.profiler``: a bf16 forward call (the inference form
    at rate 0, the training form at 0.1) launches one CUDA kernel, ``fwd_kernel``
    in the wgmma form, ``attention_bf16_kernel`` in the mma.sync form, as
    ``bf16_forward_form`` states; no other device work."""
    tq = tk if family == "masked" else 130
    q, k, v, bias, _ = _bf16_family_inputs(family, 2, 2, tq, tk, d, seed=4)
    assert attention.bf16_forward_form(family, tk, d) == form
    fwd = getattr(attention, f"{family}_attention_forward")
    seed = _seed(hopper, 6)

    def call():
        if rate == 0.0:
            return fwd(q, k, v, bias, d ** -0.5)
        return fwd(q, k, v, bias, d ** -0.5, rate, seed, True)
    call()  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    want = "fwd_kernel" if form == "wgmma" else "attention_bf16_kernel"
    assert len(names) == 1 and want in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("family", ["masked", "bias"])
@pytest.mark.parametrize("d", range(8, 257, 8))
def test_bf16_training_forward_every_head_dim_twice_bit_identical(hopper, d, family, rate):
    """The training forward at every head dim (causal T = 128: two key tiles;
    bias: the path's padded keys, TQ 130 with a wholly masked row) within the
    bf16 forward's bound of the plain version under the same keep mask, its
    statistics finite, and a second call equal bit for bit, output and
    statistics."""
    tq, tk = (128, 128) if family == "masked" else (130, PATH_KEY_TILE)
    q, k, v, bias, _ = _bf16_family_inputs(family, 2, 2, tq, tk, d, seed=d + 11,
                                           masked_row=True)
    scale = d ** -0.5
    seed = _seed(hopper, 900 + d)
    fwd = getattr(attention, f"{family}_attention_forward")
    ref = getattr(attention, f"{family}_attention_reference")
    out, stats = fwd(q, k, v, bias, scale, rate, seed, True)
    again, stats_again = fwd(q, k, v, bias, scale, rate, seed, True)
    torch.cuda.synchronize()
    keep = attention.dropout_keep_reference(seed, 2, 2, tq, tk, rate) if rate > 0 else None
    want = ref(q, k, v, bias, scale, keep, rate)
    bound = 2.0 ** -7 * ref(q, k, v.float().abs(), bias, scale, keep, rate) + 1e-5
    assert float(((out - want).abs() / bound).max()) <= 1.0
    assert torch.isfinite(stats).all()
    assert torch.equal(out, again) and torch.equal(stats, stats_again)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel_attention", [False, True])
def test_bf16_train_step_on_the_card(hopper, kernel_attention):
    """``make_train_step`` on a bf16 model at the kernel gates (T >= 256,
    S >= 512): finite losses; the kernel route launches the bf16 training
    forms and bf16 backwards of B3 and B5 and none of their fp32 forms, the
    default route none of either; the parameters stay float32."""
    from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.train import trainer
    from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
    from streamspeech_tpu_torch.weights import random_init_

    cfg = tiny_config(vocab_text=512, upsample=25)
    model = random_init_(StreamSpeechModel(cfg, dtype=torch.bfloat16), 0).to(hopper)
    tx = trainer.make_optimizer(OptimizationConfig(update_freq=1))
    step = trainer.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                                   kernel_attention=kernel_attention)
    batch = batch_to_tensors(synthetic_batch(cfg, batch=2, frames=1024, mt_len=24),
                             device=hopper)
    fns = (attention.masked_attention, attention.bias_attention,
           attention.masked_attention_backward, attention.bias_attention_backward)
    before = [(f.launches, f.bf16_launches) for f in fns]
    state, metrics = step(trainer.TrainState.create(model, tx), batch,
                          torch.Generator(device=hopper).manual_seed(0), 8, 8)
    torch.cuda.synchronize()
    after = [(f.launches, f.bf16_launches) for f in fns]
    per = 1 if kernel_attention else 0
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == [(0, per)] * 4
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert {p.dtype for p in model.parameters()} == {torch.float32}
