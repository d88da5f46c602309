"""The port's SSD chunk scan against the JAX package, on the CPU.

On CPU tensors the ``ssd_scan`` wrapper runs its plain PyTorch version
(``kernels/ssd_scan/ref.py``); it is held against the Pallas kernel in
interpret mode and the JAX oracle ``ssd_scan_ref``, and its final state
against a numpy token recurrence.  The models' ``ssm_impl="torch"`` path
runs the same plain version.
Inputs are made with numpy from seeds; bf16 inputs are rounded once by JAX
and carried to torch bit for bit.  Tolerance: ``tests/test_kernels.py``'s
for this kernel, f32 2e-5 and bf16 2e-2 times 5 (atol and rtol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as ssd_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_token_ref
from repro.models import ssm as JS
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_bwd_passes_ref,
                                              ssd_scan_chunked_ref,
                                              ssd_scan_passes_ref,
                                              ssd_scan_token_ref)
from repro_torch.models import ssm as TS
from repro_torch.models.convert import tensor_from_numpy

TOL = {"float32": 2e-5 * 5, "bfloat16": 2e-2 * 5}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (B, nc, Q, nh, hd, ns): the sweep of tests/test_kernels.py:44-48, then
# Q = 1 (a prime prompt length's chunk) and nc = 5
SHAPES = [(1, 2, 8, 2, 8, 4), (2, 4, 16, 3, 8, 4), (1, 3, 32, 4, 16, 8),
          (2, 7, 1, 3, 16, 8), (1, 5, 12, 2, 16, 16)]

_token_ref = jax.jit(jax_token_ref)


def _inputs(B, nc, Q, nh, hd, ns, dtype, seed, da_scale=0.5):
    """(jax arrays, torch tensors) of x, b, c, dt, da from numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, nc, Q, nh, hd).astype(np.float32)
    b = rng.randn(B, nc, Q, ns).astype(np.float32)
    c = rng.randn(B, nc, Q, ns).astype(np.float32)
    dt = (rng.rand(B, nc, Q, nh) * 0.1).astype(np.float32)
    da = (-rng.rand(B, nc, Q, nh) * da_scale).astype(np.float32)
    jx = [jnp.asarray(a, JDT[dtype]) for a in (x, b, c)] \
        + [jnp.asarray(dt), jnp.asarray(da)]
    return jx, [tensor_from_numpy(np.asarray(a), "cpu") for a in jx]


def _close(got: torch.Tensor, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _numpy_state(x, b, dt, da):
    """Final state of the token recurrence h_t = exp(da_t) h + dt_t b_t x_t,
    in f64."""
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    T = nc * Q
    x = x.float().numpy().astype(np.float64).reshape(B, T, nh, hd)
    b = b.float().numpy().astype(np.float64).reshape(B, T, ns)
    dt = dt.numpy().astype(np.float64).reshape(B, T, nh)
    da = da.numpy().astype(np.float64).reshape(B, T, nh)
    h = np.zeros((B, nh, ns, hd))
    for t in range(T):
        h = np.exp(da[:, t])[:, :, None, None] * h + np.einsum(
            "bs,bh,bhd->bhsd", b[:, t], dt[:, t], x[:, t])
    return h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nc,Q,nh,hd,ns", SHAPES)
def test_plain_ssd_scan_matches_pallas_and_oracle(B, nc, Q, nh, hd, ns,
                                                  dtype):
    jx, tx = _inputs(B, nc, Q, nh, hd, ns, dtype, seed=nc * Q + hd)
    got = ssd_scan(*tx)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    _close(got, ssd_pallas(*jx, interpret=True), dtype)
    _close(got, _token_ref(*jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nc,Q,nh,hd,ns", SHAPES)
def test_final_state_matches_token_recurrence(B, nc, Q, nh, hd, ns, dtype):
    _, tx = _inputs(B, nc, Q, nh, hd, ns, dtype, seed=nc + Q * hd)
    y, h = ssd_scan(*tx, return_state=True)
    assert h.dtype == torch.float32 and h.shape == (B, nh, ns, hd)
    torch.testing.assert_close(y, ssd_scan(*tx), atol=0, rtol=0)
    x, b, _c, dt, da = tx
    want = _numpy_state(x, b, dt, da)
    np.testing.assert_allclose(h.numpy(), want, atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("B,nc,Q,nh,hd,ns", SHAPES)
def test_plain_ssd_scan_in_f64_is_the_exact_recurrence(B, nc, Q, nh, hd, ns):
    """f64 inputs run the plain version in f64 (the yardstick that the card
    check holds the f32 kernel to under strong decays): its state is the
    token recurrence's in f64, and its y the f32 plain version's."""
    _, tx = _inputs(B, nc, Q, nh, hd, ns, "float32", seed=nc + Q + ns)
    y, h = ssd_scan_chunked_ref(*(t.double() for t in tx))
    assert y.dtype == h.dtype == torch.float64
    np.testing.assert_allclose(h.numpy(), _numpy_state(*tx[:2], *tx[3:]),
                               atol=1e-12, rtol=1e-12)
    _close(y, ssd_scan_chunked_ref(*tx)[0], "float32")


@pytest.mark.parametrize("B,nc,Q,nh,hd,ns", SHAPES)
def test_token_oracle_matches_jax(B, nc, Q, nh, hd, ns):
    jx, tx = _inputs(B, nc, Q, nh, hd, ns, "float32", seed=3)
    _close(ssd_scan_token_ref(*tx), _token_ref(*jx), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decay_that_overflows_above_the_diagonal_stays_finite(dtype):
    """mamba2's A reaches -exp(log 32): with dt 0.1 and Q 256 the chunk's
    cumulative decay reaches -819, so exp(cs_q - cs_p) is inf for q < p.
    Selecting (not masking by multiplication) keeps y and h finite."""
    B, nc, Q, nh, hd, ns = 1, 2, 256, 2, 8, 4
    jx, tx = _inputs(B, nc, Q, nh, hd, ns, dtype, seed=5)
    da = torch.full((B, nc, Q, nh), -3.2)
    dt = torch.full((B, nc, Q, nh), 0.1)
    cs = torch.cumsum(da[0, 0, :, 0], 0)
    assert torch.isinf(torch.exp(cs[0] - cs[-1]))
    x, b, c = tx[:3]
    y, h = ssd_scan_chunked_ref(x, b, c, dt, da)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want = _token_ref(*jx[:3], jnp.asarray(dt.numpy()),
                      jnp.asarray(da.numpy()))
    _close(ssd_scan(x, b, c, dt, da), want, dtype)


# f32: the passes regroup the chunked version's f32 sums (they agree to
# 0 on the CPU); the Pallas kernel sums in its own order and is held to
# this file's f32 tolerance, as the chunked version is
PASS_TOL = 1e-5


@pytest.mark.parametrize("ns,hd", [(16, 16), (128, 64)])
@pytest.mark.parametrize("nc", [1, 3, 8])
@pytest.mark.parametrize("Q", [1, 7, 100, 256])
def test_passes_match_chunked_ref_and_pallas(Q, nc, ns, hd):
    """The three passes of the bf16 CUDA kernels (chunk states, state
    passing, chunk outputs), in plain f32, give the chunked function's y
    and final state, and the Pallas kernel's y."""
    jx, tx = _inputs(1, nc, Q, 2, hd, ns, "float32", seed=Q + nc + ns)
    y, h = ssd_scan_passes_ref(*tx)
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=PASS_TOL,
                               rtol=PASS_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), atol=PASS_TOL,
                               rtol=PASS_TOL)
    _close(y, ssd_pallas(*jx, interpret=True), "float32")


def test_passes_keep_an_overflowing_decay_finite():
    """The decay of the chunk-output pass is inf above the diagonal at
    mamba2's strongest decay; it is selected away, never multiplied."""
    _, tx = _inputs(1, 2, 256, 2, 16, 8, "float32", seed=6)
    x, b, c = tx[:3]
    dt = torch.full((1, 2, 256, 2), 0.1)
    da = torch.full((1, 2, 256, 2), -3.2)
    y, h = ssd_scan_passes_ref(x, b, c, dt, da)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want_y, want_h = ssd_scan_chunked_ref(x, b, c, dt, da)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=PASS_TOL,
                               rtol=PASS_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), atol=PASS_TOL,
                               rtol=PASS_TOL)


# f32: a group boundary only cuts pass B's walk over the chunks, and the
# state crosses it in f32 as it crosses a chunk boundary
GROUP_TOL = 1e-6


@pytest.mark.parametrize("nc,group", [(7, 1), (7, 3), (7, 7), (16, 1),
                                      (16, 3), (16, 16)])
def test_grouped_passes_match_chunked_ref(nc, group):
    """The three passes over groups of at most ``group`` chunks, the state
    carried from group to group (the bf16 kernel's bounded scratch), give
    the chunked function's y and final state; nc 7 and 16 are no multiple
    of 3, so the last group is short."""
    _, tx = _inputs(2, nc, 5, 3, 16, 8, "float32", seed=nc * 10 + group)
    y, h = ssd_scan_passes_ref(*tx, group=group)
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=GROUP_TOL,
                               rtol=GROUP_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), atol=GROUP_TOL,
                               rtol=GROUP_TOL)


def _chunk(S, chunk=256):
    """Q as ``models.ssm.ssd_apply`` chooses it: the largest divisor of S
    up to the configured chunk."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


# (B, S) -> (G, bytes) at mamba2-370m's SSD shape (nh 32, hd 64, ns 128,
# chunk 256): (2 ns hd + Q + 1) floats per (batch, chunk, head), as many
# chunks as fit SCRATCH_BUDGET (128 MiB)
MAMBA2_PLANS = {(4, 2048): (8, 68161536), (4, 2053): (15, 125844480),
                (16, 2048): (3, 102242304), (16, 2053): (3, 100675584)}


@pytest.mark.parametrize("B,S", sorted(MAMBA2_PLANS))
def test_scratch_plan_at_mamba2_shape(B, S):
    """The bf16 wrapper's groups and scratch at mamba2's shape: one group
    of 8 chunks at the serve prompt (2,048 tokens, B 4), as before the
    grouping; at a prime length (Q 1, nc 2,053) the scratch stays within
    the budget instead of the 17.2 GB one group of 2,053 chunks needs."""
    Q = _chunk(S)
    nc = S // Q
    G, nbytes = ssd_ops.scratch_plan(B, nc, Q, 32, 64, 128)
    assert (G, nbytes) == MAMBA2_PLANS[(B, S)]
    assert nbytes == G * 4 * B * 32 * (2 * 128 * 64 + Q + 1)
    assert nbytes <= ssd_ops.SCRATCH_BUDGET and B * G <= ssd_ops.MAX_GRID
    # the budget holds the serve prompt's one group, and at most twice it
    assert MAMBA2_PLANS[(4, 2048)][1] <= ssd_ops.SCRATCH_BUDGET \
        <= 2 * MAMBA2_PLANS[(4, 2048)][1]
    if (B, S) == (4, 2048):
        assert G == nc


def test_scratch_plan_fits_the_grid_and_takes_a_group(monkeypatch):
    """B nc > 65,535 is cut into groups whose grids fit; a budget of 3
    chunks' scratch takes groups of 3, one above nc takes one group, and
    one below a chunk's scratch still takes a chunk a group."""
    G, _ = ssd_ops.scratch_plan(33, 2000, 1, 1, 16, 16)
    assert 1 <= G <= 65535 // 33 < 2000
    per_chunk = 4 * 2 * 3 * (2 * 128 * 64 + 64 + 1)
    for budget, want in ((3 * per_chunk, 3), (3 * per_chunk + 7, 3),
                         (99 * per_chunk, 16), (per_chunk - 1, 1)):
        monkeypatch.setattr(ssd_ops, "SCRATCH_BUDGET", budget)
        assert ssd_ops.scratch_plan(2, 16, 64, 3, 64, 128) == \
            (want, want * per_chunk)


# (B, nc, Q, nh, hd, ns, group, da): the backward passes' cases, f64
BWD_CASES = [(1, 1, 1, 3, 64, 16, None, "mild"),
             (2, 8, 1, 3, 64, 128, 3, "mild"),
             (1, 3, 7, 3, 64, 16, None, "mild"),
             (1, 5, 7, 50, 64, 16, 2, "mild"),
             (1, 2, 100, 3, 64, 128, 1, "mild"),
             (1, 2, 100, 50, 64, 16, None, "mild"),
             (1, 1, 256, 3, 64, 128, None, "mild"),
             (1, 2, 256, 3, 64, 16, None, "overflow"),
             (1, 4, 7, 3, 64, 16, 3, "overflow")]


@pytest.mark.parametrize("B,nc,Q,nh,hd,ns,group,decay", BWD_CASES)
def test_bwd_passes_are_autograds_gradient(B, nc, Q, nh, hd, ns, group,
                                           decay):
    """The backward kernels' passes (the entering states recomputed, the
    state gradients' reverse pass, the per-chunk pass), in f64, give
    autograd's gradient of the chunked function for every input, with and
    without a final state's gradient, also over groups of chunks.  At
    mamba2's strongest decay (da -3.2 over up to 256 rows) the decay above
    the diagonal is inf, and the gradient stays finite and is 0 there: a
    dy on the first row of the last chunk alone reaches no later x."""
    _, tx = _inputs(B, nc, Q, nh, hd, ns, "float32", seed=Q + nc + nh)
    x, b, c, dt, da = (t.double() for t in tx)
    if decay == "overflow":
        dt, da = torch.full_like(dt, 0.1), torch.full_like(da, -3.2)
        cs = torch.cumsum(da[0, 0, :, 0], 0)
        assert Q < 256 or torch.isinf(torch.exp(cs[0] - cs[-1]).float())
    gen = torch.Generator().manual_seed(Q + 1)
    dy = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    dh = torch.randn((B, nh, ns, hd), generator=gen, dtype=torch.float64)
    for d_state in (None, dh):
        xs = [t.clone().requires_grad_(True) for t in (x, b, c, dt, da)]
        y, h = ssd_scan_chunked_ref(*xs)
        outs, gs = ([y, h], [dy, d_state]) if d_state is not None \
            else ([y], [dy])
        want = torch.autograd.grad(outs, xs, gs)
        got = ssd_scan_bwd_passes_ref(x, b, c, dt, da, dy, d_state,
                                      group=group)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
            # inputs are O(1): an exactly-zero gradient reads f64 noise
            assert float((g - w).abs().max()) <= 1e-9 * max(
                float(w.abs().max()), 1.0)
    if decay == "overflow":
        one = torch.zeros_like(dy)
        one[:, -1, 0] = dy[:, -1, 0]
        dx = ssd_scan_bwd_passes_ref(x, b, c, dt, da, one, group=group)[0]
        assert bool(torch.isfinite(dx).all())
        assert not bool(dx[:, -1, 1:].any()) and bool(dx[:, -1, 0].any())


def test_bwd_passes_keep_the_inputs_dtypes():
    """In f32 and bf16: dx, db and dc in the inputs' dtype, ddt and dda in
    f32, within the f32 tolerance of autograd on the same f32 values."""
    for dtype in ("float32", "bfloat16"):
        _, tx = _inputs(1, 3, 16, 3, 16, 8, dtype, seed=4)
        dy = torch.randn(tx[0].shape, generator=torch.Generator()
                         .manual_seed(3)).to(tx[0].dtype)
        got = ssd_scan_bwd_passes_ref(*tx, dy, group=2)
        xs = [t.float().requires_grad_(True) for t in tx]
        want = torch.autograd.grad(ssd_scan_chunked_ref(*xs)[0], xs,
                                   dy.float())
        for g, w, t in zip(got, want, tx):
            assert g.dtype == (t.dtype if g is not got[3] and g is not got[4]
                               else torch.float32)
            tol = TOL[dtype] * float(w.abs().max())
            assert float((g.float() - w).abs().max()) <= tol


def test_with_grad_on_the_cpu_is_plain_autograd_bit_for_bit():
    """The model's Function on CPU tensors: the forward is the plain
    version's, and the backward the plain version's autograd, recomputed:
    gradients equal bit for bit, with and without the final state's
    gradient, for the inputs that require one, and no launch."""
    _, tx = _inputs(2, 3, 7, 3, 8, 4, "float32", seed=21)
    gen = torch.Generator().manual_seed(22)
    dy = torch.randn(tx[0].shape, generator=gen)
    dh = torch.randn((2, 3, 4, 8), generator=gen)
    _build.reset_launches()
    for wanted in ((True,) * 5, (True, False, True, False, True)):
        for with_h in (False, True):
            xs = [t.clone().requires_grad_(w) for t, w in zip(tx, wanted)]
            ys = [t.clone().requires_grad_(w) for t, w in zip(tx, wanted)]
            y, h = ssd_ops.ssd_scan_with_grad(ssd_scan_chunked_ref, *xs)
            y2, h2 = ssd_scan_chunked_ref(*ys)
            assert torch.equal(y, y2) and torch.equal(h, h2)
            outs = ([y, h], [dy, dh]) if with_h else ([y], [dy])
            outs2 = ([y2, h2], [dy, dh]) if with_h else ([y2], [dy])
            got = torch.autograd.grad(outs[0], [t for t in xs
                                                if t.requires_grad], outs[1])
            want = torch.autograd.grad(outs2[0], [t for t in ys
                                                  if t.requires_grad],
                                       outs2[1])
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.launch_counts() == {}
    with torch.no_grad():
        y, h = ssd_ops.ssd_scan_with_grad(ssd_scan_chunked_ref, *tx)
    assert y.grad_fn is None
    got = ssd_ops.ssd_scan_bwd(*tx, dy, dh)
    xs = [t.clone().requires_grad_(True) for t in tx]
    want = torch.autograd.grad(list(ssd_scan_chunked_ref(*xs)), xs, [dy, dh])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("forward", ["torch", "cuda"])
def test_the_dry_run_counts_the_backward_kernel_on_cpu_fakes(forward):
    """Fake CPU tensors (the dry run's check of its cuda cells) take the
    backward operator, as fake CUDA tensors do: one call, twice the
    forward's FLOPs and no op of the plain recompute, and the kernel's
    scratch in the peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.step_analysis import (StepCounter,
                                                  ssd_scan_bwd_scratch,
                                                  ssd_scan_flops)
    B, nc, Q, nh, hd, ns = 2, 4, 64, 3, 16, 8
    fwd = {"torch": ssd_scan_chunked_ref, "cuda": ssd_ops.ssd_scan_op}
    with FakeTensorMode():
        tx = [torch.empty(s) for s in ((B, nc, Q, nh, hd), (B, nc, Q, ns),
                                       (B, nc, Q, ns), (B, nc, Q, nh),
                                       (B, nc, Q, nh))]
        xs = [t.clone().requires_grad_(True) for t in tx]
        y, _ = ssd_ops.ssd_scan_with_grad(fwd[forward], *xs)
        dy = torch.empty_like(y)
        counter = StepCounter()
        with counter:
            grads = torch.autograd.grad(y, xs, dy)
    assert [g.shape for g in grads] == [t.shape for t in tx]
    assert counter.flops_by_op == {"repro_torch.ssd_scan_bwd":
                                   2 * ssd_scan_flops(*tx)}
    assert counter.peak_bytes >= ssd_scan_bwd_scratch(*tx) > 0


def test_bwd_scratch_plan():
    """The training step's shape (B 16, nc 8, Q 256) runs in one group;
    a prime length (Q 1, nc 2,003) in groups whose scratch fits the
    budget, the entering states of all groups but the first kept apart;
    a chunk too large for the budget still takes a group of one."""
    G, nbytes, bbytes = ssd_ops.bwd_scratch_plan(16, 8, 256, 32, 64, 128)
    assert (G, bbytes) == (8, 0) and nbytes <= ssd_ops.BWD_SCRATCH_BUDGET
    G, nbytes, bbytes = ssd_ops.bwd_scratch_plan(2, 2003, 1, 32, 64, 128)
    groups = -(-2003 // G)
    assert 1 < G < 2003 and nbytes <= ssd_ops.BWD_SCRATCH_BUDGET
    assert bbytes == (groups - 1) * 4 * 2 * 32 * 128 * 64
    assert ssd_ops.bwd_scratch_plan(16, 3, 4096, 32, 128, 128)[0] == 1


def _bf16_once(t):
    return t.to(torch.bfloat16).float()


def _bf16_hi_lo(t):
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("rounding", ["once", "hi_lo"])
def test_bf16_operands_stay_within_the_bf16_tolerance(rounding):
    """The bf16 kernels take W, the decay-scaled x and h into the tensor
    cores as bf16.  At one head of mamba2's shape (Q 256, ns 128, hd 64,
    nc 3) either rounding -- once, or as a hi + lo pair -- keeps y within
    the kernel's bf16 tolerance of the plain version.  The kernels use
    hi + lo: rounded once, y moves by more than 1e-3 (relative L2) in one
    layer, too much of the 2e-3 a layer that mamba2's serve bound leaves
    the whole path; hi + lo moves it by under 5e-4."""
    _, tx = _inputs(1, 3, 256, 1, 64, 128, "bfloat16", seed=12)
    op = _bf16_once if rounding == "once" else _bf16_hi_lo
    y, h = ssd_scan_passes_ref(*tx, operand=op)
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    _close(y, want_y, "bfloat16")
    _close(h, want_h, "bfloat16")
    rel = float((y.float() - want_y.float()).norm() / want_y.float().norm())
    if rounding == "hi_lo":
        assert rel < 5e-4
    else:
        assert rel > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_inputs_are_read_through_their_strides(dtype):
    """x, b and c as column slices of one (B, S, C) tensor viewed as
    chunks, as the model passes them."""
    B, nc, Q, nh, hd, ns = 2, 3, 8, 2, 16, 8
    rng = np.random.RandomState(9)
    di = nh * hd
    xbc = torch.from_numpy(rng.randn(B, nc * Q, di + 2 * ns)
                           .astype(np.float32)).to(dtype)
    x = xbc[..., :di].reshape(B, nc, Q, nh, hd)
    b = xbc[..., di:di + ns].reshape(B, nc, Q, ns)
    c = xbc[..., di + ns:].reshape(B, nc, Q, ns)
    assert not (x.is_contiguous() or b.is_contiguous())
    dt = torch.from_numpy((rng.rand(B, nc, Q, nh) * 0.1).astype(np.float32))
    da = torch.from_numpy((-rng.rand(B, nc, Q, nh)).astype(np.float32))
    y, h = ssd_scan(x, b, c, dt, da, return_state=True)
    y2, h2 = ssd_scan(x.contiguous(), b.contiguous(), c.contiguous(), dt,
                      da, return_state=True)
    torch.testing.assert_close(y, y2, atol=0, rtol=0)
    torch.testing.assert_close(h, h2, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["rank", "dtype_mix", "dt_dtype", "shape",
                                  "state_too_wide", "dt_strided",
                                  "last_stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    _, (x, b, c, dt, da) = _inputs(1, 2, 4, 2, 8, 4, "float32", seed=1)
    if case == "rank":
        x = x[0]
    elif case == "dtype_mix":
        b = b.to(torch.bfloat16)
    elif case == "dt_dtype":
        dt = dt.double()
    elif case == "shape":
        c = c[:, :, :3]
    elif case == "state_too_wide":
        b = torch.zeros(1, 2, 4, 129)
        c = b.clone()
    elif case == "dt_strided":
        dt = dt.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "last_stride":
        x = x.transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises((TypeError, ValueError)):
        ssd_scan(x, b, c, dt, da)


def test_plain_version_counts_no_launches():
    _build.reset_launches()
    _, tx = _inputs(1, 2, 4, 2, 8, 4, "float32", seed=2)
    ssd_scan(*tx, return_state=True)
    assert _build.launch_counts().get("ssd_scan", 0) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.RandomState(4)
    jx = jnp.asarray(rng.randn(2, 9, 24).astype(np.float32), JDT[dtype])
    jw = jnp.asarray(rng.randn(4, 24).astype(np.float32), JDT[dtype])
    jb = jnp.asarray(rng.randn(24).astype(np.float32))
    got = TS._causal_conv(*[tensor_from_numpy(np.asarray(a), "cpu")
                            for a in (jx, jw, jb)])
    assert got.dtype == tensor_from_numpy(np.asarray(jx), "cpu").dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(JS._causal_conv(jx, jw, jb),
                                          np.float32), atol=tol, rtol=tol)
