"""The CTC kernels' cut of the state axis (``csrc/ctc.cu``), emulated in plain
torch on the CPU: the states cut into slices of W, each slice stepping its own
frames, the two boundary values of a frame handed to the next slice through a
ring of R slots of K frames with the kernel's mbarrier protocol (phase parity,
armed transfers, back-pressure), under seeded schedules that let each slice run
ahead or lag as far as the ring allows. Its alpha, NLL and occupancy gradient
are held against the plain versions (``kernels.ctc.*_reference``) and against
JAX's Pallas kernels in interpret mode (``_run_alpha``, ``ctc_nll_pallas`` and
its custom_vjp), built once for the file.

Tolerances: alpha and the NLL within 1e-5 * max(1, |ref|), the gradient within
1e-6 absolute (its values lie in [-1, 0]): the card's tolerances
(``chip_smoke.py``). Against the plain versions the emulation runs the same
torch arithmetic; against JAX, XLA's exp and log on the CPU differ from
torch's in the last bits. About 35 s on one CPU worker, most of it JAX's
interpret mode building the reference once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from streamspeech_tpu.ops import pallas_ctc as jpc

from streamspeech_tpu_torch.kernels import ctc as kctc
from streamspeech_tpu_torch.ops.ctc import NNEG, lse3
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5        # alpha and NLL: |err| <= RTOL * max(1, |ref|)
GRAD_ATOL = 1e-6   # the occupancy gradient, values in [-1, 0]


class MBarrier:
    """An mbarrier with an arrival count of 1: a phase completes when its one
    arrival has come and its transfer count is back at 0."""

    def __init__(self):
        self.phase, self.pending, self.tx = 0, 1, 0

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase, self.pending = self.phase + 1, 1

    def arrive(self, expect_bytes=0):
        assert self.pending == 1, "a second arrival on one phase"
        self.pending, self.tx = 0, self.tx + expect_bytes
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def done(self, parity):
        """try_wait.parity: the phase of this parity has completed."""
        return self.phase % 2 != parity


class Ring:
    """One boundary of the cut: ``ctc.cu``'s Ring, RingOut and RingIn for n
    frames in batches of k, r slots."""

    def __init__(self, n, k, r):
        self.n, self.k, self.r = n, k, r
        self.full = [MBarrier() for _ in range(r)]
        self.empty = [MBarrier() for _ in range(r)]
        self.slot = [[None] * k for _ in range(r)]
        self.staging = [[None] * k for _ in range(r)]
        self.blocked_sends = 0
        for i in range(r):
            if self.batch_bytes(i):
                self.full[i].arrive(self.batch_bytes(i))

    def batch_bytes(self, j):
        left = self.n - j * self.k
        return 0 if left <= 0 else 16 * ((min(left, self.k) + 1) // 2)

    def can_send(self, f):
        j, pos = divmod(f, self.k)
        ok = pos != 0 or j < self.r or self.empty[j % self.r].done((j // self.r - 1) % 2)
        self.blocked_sends += not ok
        return ok

    def send(self, f, pair):
        j, pos = divmod(f, self.k)
        i = j % self.r
        self.staging[i][pos] = pair
        if pos == self.k - 1 or f == self.n - 1:          # the bulk copy of the batch
            self.slot[i] = list(self.staging[i])
            self.full[i].complete_tx(self.batch_bytes(j))

    def can_receive(self, f):
        j, pos = divmod(f, self.k)
        return pos != 0 or self.full[j % self.r].done((j // self.r) % 2)

    def receive(self, f):
        j, pos = divmod(f, self.k)
        i = j % self.r
        pair = self.slot[i][pos]
        assert pair is not None and pair[0] == f, f"frame {f} read {pair and pair[0]}"
        if pos == self.k - 1 or f == self.n - 1:
            if self.batch_bytes(j + self.r):
                self.full[i].arrive(self.batch_bytes(j + self.r))
            self.empty[i].arrive()
        return pair[1], pair[2]


def _run(n_slices, n_steps, can_step, step, seed):
    """Advance the slices in a seeded random order, each 0 to 3 steps a round,
    until every slice is done; fail if the schedule deadlocks."""
    rng = np.random.RandomState(seed)
    nxt, idle = [0] * n_slices, 0
    while min(nxt) < n_steps:
        moved = False
        for g in rng.permutation(n_slices):
            for _ in range(rng.randint(0, 4)):
                if nxt[g] < n_steps and can_step(g, nxt[g]):
                    step(g, nxt[g])
                    nxt[g] += 1
                    moved = True
        idle = 0 if moved else idle + 1
        assert idle < 200, f"the ring deadlocked at steps {nxt}"


def _slices(s, width):
    return [slice(g * width, (g + 1) * width) for g in range(-(-s // width))]


def cluster_alpha(lp, init, skip, valid, width, k, r, seed):
    """The alpha kernel's decomposition: alpha [B, T, S] and its rings."""
    b, t_len, s = lp.shape
    sl = _slices(s, width)
    s_pad = len(sl) * width
    lp_p = F.pad(lp, (0, s_pad - s), value=0.0)          # the zero-filled fetch past S
    init_p, skip_p = (F.pad(x, (0, s_pad - s), value=NNEG) for x in (init, skip))
    rings = [Ring(t_len - 1, k, r) for _ in sl[1:]]      # ring g feeds slice g + 1
    cur = [init_p[:, x] + lp_p[:, 0, x] for x in sl]
    out = torch.empty(b, t_len, s_pad)
    out[:, 0] = torch.cat(cur, 1)
    nneg = torch.full((b,), NNEG)

    def can_step(g, i):                                  # step i is frame t = i + 1
        return (g == 0 or rings[g - 1].can_receive(i)) and \
            (g + 1 == len(sl) or rings[g].can_send(i))

    def step(g, i):
        t = i + 1
        c = cur[g]
        if g + 1 < len(sl):                              # frame t - 1 goes up first
            rings[g].send(t - 1, (t - 1, c[:, -1], c[:, -2]))
        p1, p2 = rings[g - 1].receive(t - 1) if g > 0 else (nneg, nneg)
        a1 = torch.cat([p1[:, None], c[:, :-1]], 1)
        a2 = torch.cat([p2[:, None], p1[:, None], c[:, :-2]], 1)
        new = lse3(c, a1, a2 + skip_p[:, sl[g]]) + lp_p[:, t, sl[g]]
        cur[g] = c = torch.where(valid[:, t, None] > 0, new, c)
        out[:, t, sl[g]] = c

    _run(len(sl), t_len - 1, can_step, step, seed)
    return out[:, :, :s], rings


def cluster_beta_grad(lp, end, skip, zbias, valid, alpha, width, k, r, seed):
    """The beta kernel's decomposition: the occupancy gradient [B, T, S] and its rings."""
    b, t_len, s = lp.shape
    sl = _slices(s, width)
    s_pad = len(sl) * width
    lp_p, alpha_p = (F.pad(x, (0, s_pad - s), value=0.0) for x in (lp, alpha))
    end_p = F.pad(end, (0, s_pad - s), value=NNEG)
    skip_p = F.pad(skip, (0, s_pad + 2 - s), value=NNEG)  # skip at s + 2 past the end
    rings = [Ring(t_len, k, r) for _ in sl[1:]]          # ring g feeds slice g from g + 1
    beta = [end_p[:, x] for x in sl]
    grad = torch.empty(b, t_len, s_pad)
    nneg = torch.full((b,), NNEG)

    def can_step(g, i):
        return (g == 0 or rings[g - 1].can_send(i)) and \
            (g + 1 == len(sl) or rings[g].can_receive(i))

    def step(g, i):
        t = t_len - 1 - i
        x = sl[g]
        q = beta[g] + lp_p[:, t, x]
        if g > 0:
            rings[g - 1].send(i, (i, q[:, 0], q[:, 1]))
        n1, n2 = rings[g].receive(i) if g + 1 < len(sl) else (nneg, nneg)
        q1 = torch.cat([q[:, 1:], n1[:, None]], 1)
        q2 = torch.cat([q[:, 2:], n1[:, None], n2[:, None]], 1)
        nb = lse3(q, q1, q2 + skip_p[:, x.start + 2:x.stop + 2])
        v = valid[:, t, None] > 0
        gamma = torch.exp(torch.clamp(alpha_p[:, t, x] + beta[g] + zbias[:, None], max=0.0))
        grad[:, t, x] = torch.where(v, -gamma, torch.zeros_like(gamma))
        beta[g] = torch.where(v, nb, beta[g])

    _run(len(sl), t_len, can_step, step, seed)
    return grad[:, :, :s], rings


def _parts(seed, b, t, v, n, lengths, label_lengths, labels=None, s_pad=None, s_cut=None):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(b, t, v).astype(np.float32) * 2)
    if labels is None:
        labels = rng.randint(1, v, size=(b, n))
    parts = kctc.ext_and_masks(logits, torch.tensor(lengths), torch.tensor(np.asarray(labels)),
                               torch.tensor(label_lengths), 0)
    if s_pad is not None:                                # unreachable states appended
        parts = {key: x if key == "validmask" else F.pad(x, (0, s_pad - x.shape[-1]),
                                                          value=NNEG)
                 for key, x in parts.items()}
    if s_cut is not None:                                # the first states only
        parts = {key: x if key == "validmask" else x[..., :s_cut].contiguous()
                 for key, x in parts.items()}
    return parts


# name: (DP inputs, slice width W, frames a batch K, ring slots R)
CASES = {
    # S = 2W: the last slice ends on the last state (one state padded in)
    "s_multiple_of_w": (lambda: _parts(1, 3, 24, 9, 7, [24, 20, 13], [7, 5, 6], s_pad=16),
                        8, 2, 2),
    "s_w_plus_one": (lambda: _parts(2, 3, 24, 9, 4, [24, 24, 17], [4, 4, 2]), 8, 4, 2),
    "s_less_than_w": (lambda: _parts(3, 2, 16, 7, 2, [16, 11], [2, 1]), 8, 2, 2),
    "s_one_no_labels": (lambda: _parts(4, 2, 16, 5, 1, [16, 9], [0, 0], s_cut=1), 4, 2, 2),
    # repeated labels put a NNEG skip at s = 5, whose s - 2 is in the slice below;
    # rows padded to 17 and 9 frames
    "padded_repeated": (lambda: _parts(5, 3, 24, 6, 5, [24, 17, 9], [5, 5, 4],
                                       labels=[[1, 2, 2, 3, 3], [4, 4, 4, 1, 2],
                                               [1, 2, 3, 4, 5]]), 4, 2, 2),
    # row 0 needs 11 frames for 6 equal labels and has 8: NLL NNEG, grad exactly 0
    "impossible": (lambda: _parts(6, 2, 8, 6, 6, [8, 8], [6, 3],
                                  labels=[[1] * 6, [2, 3, 4, 1, 1, 1]]), 4, 2, 2),
    # the unit CTC's S = 513 (256 labels, 6 and 3 of them real) at a short T, the
    # kernel's own warp slices of 32 and K, R
    "unit_513": (lambda: _parts(7, 2, 16, 40, 256, [16, 12], [6, 3]), 32, 8, 4),
}


def _jax_aux(parts):
    b, t, s = parts["lp_ext"].shape
    return {"initmask": jnp.asarray(parts["initmask"].numpy()),
            "endmask": jnp.asarray(parts["endmask"].numpy()),
            "skipmask": jnp.asarray(parts["skipmask"].numpy()),
            "validmask": jnp.broadcast_to(jnp.asarray(parts["validmask"].numpy())[:, :, None],
                                          (b, t, s))}


@pytest.fixture(scope="module")
def reference():
    """Per case: the inputs, the plain versions' alpha, NLL and gradient, and
    JAX's alpha, NLL and gradient (interpret mode), computed once."""
    out = {}
    for name, (make, _, _, _) in CASES.items():
        p = make()
        lp, init, end, skip, valid = (p[key] for key in ("lp_ext", "initmask", "endmask",
                                                          "skipmask", "validmask"))
        alpha = kctc.ctc_alpha_reference(lp, init, skip, valid)
        nll, logz = kctc.nll_from_alpha(alpha, end)
        zbias = torch.where(logz > NNEG / 2, -logz, torch.full_like(logz, NNEG))
        grad = kctc.ctc_beta_grad_reference(lp, end, skip, zbias, valid, alpha)
        aux, jlp = _jax_aux(p), jnp.asarray(lp.numpy())
        j_alpha = np.asarray(jpc._run_alpha(jlp, aux, 8, True))
        j_nll, vjp = jax.vjp(lambda x: jpc.ctc_nll_pallas(x, aux, 8, True), jlp)
        j_grad = np.asarray(vjp(jnp.ones_like(j_nll))[0])
        out[name] = {"parts": p, "zbias": zbias, "alpha": alpha, "nll": nll, "grad": grad,
                     "jax_alpha": torch.tensor(j_alpha), "jax_nll": torch.tensor(np.asarray(j_nll)),
                     "jax_grad": torch.tensor(j_grad)}
    return out


def _assert_scaled(got, want, what):
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= RTOL, f"{what}: {float(err.max())} > {RTOL}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_cluster_alpha_and_nll_match_plain_and_jax(reference, name):
    ref, (_, width, k, r) = reference[name], CASES[name]
    p = ref["parts"]
    alpha, rings = cluster_alpha(p["lp_ext"], p["initmask"], p["skipmask"], p["validmask"],
                                 width, k, r, seed=0)
    nll, _ = kctc.nll_from_alpha(alpha, p["endmask"])
    _assert_scaled(alpha, ref["alpha"], "alpha vs plain")
    _assert_scaled(alpha, ref["jax_alpha"], "alpha vs JAX")
    _assert_scaled(nll, ref["nll"], "nll vs plain")
    _assert_scaled(nll, ref["jax_nll"], "nll vs JAX")
    assert len(rings) == -(-p["lp_ext"].shape[2] // width) - 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_cluster_beta_grad_matches_plain_and_jax(reference, name):
    ref, (_, width, k, r) = reference[name], CASES[name]
    p = ref["parts"]
    grad, _ = cluster_beta_grad(p["lp_ext"], p["endmask"], p["skipmask"], ref["zbias"],
                                p["validmask"], ref["alpha"], width, k, r, seed=0)
    torch.testing.assert_close(grad, ref["grad"], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(grad, ref["jax_grad"], atol=GRAD_ATOL, rtol=0)
    if name == "impossible":
        assert float(ref["nll"][0]) > 1e29 and not grad[0].any()
        assert not grad[p["validmask"] == 0].any()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_other_schedules_give_the_same_bits_and_use_back_pressure(reference, seed):
    """Whatever order the slices run in, the results are the same bits, and a
    producer that runs a ring's depth ahead waits for its consumer."""
    name = "padded_repeated"
    ref, (_, width, k, r) = reference[name], CASES[name]
    p = ref["parts"]
    base, _ = cluster_alpha(p["lp_ext"], p["initmask"], p["skipmask"], p["validmask"],
                            width, k, r, seed=0)
    alpha, rings = cluster_alpha(p["lp_ext"], p["initmask"], p["skipmask"], p["validmask"],
                                 width, k, r, seed=seed)
    grad, beta_rings = cluster_beta_grad(p["lp_ext"], p["endmask"], p["skipmask"],
                                         ref["zbias"], p["validmask"], ref["alpha"], width,
                                         k, r, seed=seed)
    assert torch.equal(alpha, base)
    torch.testing.assert_close(grad, ref["grad"], atol=GRAD_ATOL, rtol=0)
    assert sum(ring.blocked_sends for ring in rings + beta_rings) > 0


def test_mbarrier_emulation_counts_phases_as_the_kernel_needs():
    """An armed phase completes on its bytes whichever comes first; a second
    arrival on one phase is an error, as on the card."""
    bar = MBarrier()
    bar.complete_tx(16)                 # the copy lands before the consumer arms
    assert not bar.done(0)
    bar.arrive(16)
    assert bar.done(0) and not bar.done(1)
    bar.arrive(16)
    bar.complete_tx(16)
    assert bar.done(1)
    bar.arrive(8)
    with pytest.raises(AssertionError):
        bar.arrive(8)
