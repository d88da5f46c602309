"""Operations and bytes from shapes, against counts by hand."""

import pytest
import torch

from portbench.reference import model as ref
from portbench.roofline import counts


def test_ssd_scan_counts_by_hand():
    # B 1, 2 chunks of Q 4, 2 heads of 3, state 5
    tri = 10                                   # 4 * 5 / 2 kept pairs
    per_chunk = 2 * tri * 5 + 2 * (2 * tri * 3 + 2 * 4 * 5 * 3
                                   + 2 * 4 * 5 * 3 + 2 * 5 * 3)
    flops, nbytes = counts.ssd_scan(1, 2, 4, 2, 3, 5)
    assert flops == 2 * per_chunk
    T = 8
    assert nbytes == 2 * T * 2 * 3 * 2 + 2 * T * 5 * 2 + 2 * T * 2 * 4 \
        + 2 * 5 * 3 * 4


def test_ssd_scan_bytes_at_the_mamba2_serve_prefill():
    # the kernel wrapper documents 77.6 MB at B 4, nc 8, Q 256
    _, nbytes = counts.ssd_scan(4, 8, 256, 32, 64, 128)
    assert round(nbytes / 1e6, 1) == 77.6


@pytest.mark.parametrize("S,W,causal", [(7, 0, True), (7, 3, True),
                                        (7, 7, True), (7, 10, True),
                                        (5, 0, False), (6, 2, False)])
def test_attention_pairs_by_enumeration(S, W, causal):
    n = 0
    for q in range(S):
        for k in range(S):
            keep = (k <= q or not causal) and (not W or abs(q - k) < W
                                              if not causal else
                                              not W or k > q - W)
            n += keep
    if not causal and W:
        n = S * min(S, W)
    assert counts.attention_pairs(S, W, causal) == n


def test_flash_attention_counts_by_hand():
    flops, nbytes = counts.flash_attention(2, 4, 6, 2, 8, 0)
    assert flops == 4 * 2 * 6 * 8 * 10
    assert nbytes == 2 * 2 * 4 * 6 * 8 * 2 + 2 * 2 * 4 * 2 * 8 * 2


def _mamba(**kw):
    m = {"family": "ssm", "n_layers": 2, "d_model": 8, "ssm_expand": 2,
         "ssm_state": 4, "ssm_head_dim": 4, "ssm_chunk": 4, "conv_width": 4,
         "vocab_size": 10}
    m.update(kw)
    return m


def test_model_forward_counts_by_hand():
    m = _mamba()
    S = 8
    di, ns, nh = 16, 4, 4
    proj = 2 * S * (8 * (2 * di + 2 * ns + nh) + di * 8)
    conv = 2 * S * 4 * (di + 2 * ns)
    scan, _ = counts.ssd_scan(1, 2, 4, nh, 4, ns)
    assert counts.forward_flops(m, S, S) == 2 * (proj + conv + scan) \
        + 2 * S * 8 * 10
    assert counts.train_step_flops(m, 3, S) == 9 * counts.forward_flops(
        m, S, S)
    assert counts.prefill_flops(m, 3, S) == 3 * counts.forward_flops(m, S, 1)


def test_hybrid_counts_add_attention_and_mlp():
    m = _mamba(family="hybrid", n_heads=2, n_kv_heads=1, head_dim=4,
               d_ff=12, sliding_window=3)
    S = 8
    extra = 2 * S * (8 * 8 * 2 + 8 * 4 * 2) \
        + 4 * 2 * 4 * counts.attention_pairs(S, 3) + 2 * S * 3 * 8 * 12
    assert counts.forward_flops(m, S, 1) == counts.forward_flops(
        _mamba(), S, 1) + 2 * extra


def test_min_time_takes_the_larger_bound():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    assert counts.min_time(989e12, 0, pk) == pytest.approx(1.0)
    assert counts.min_time(0, 3.35e12, pk) == pytest.approx(1.0)
    assert counts.min_time(989e12, 6.7e12, pk) == pytest.approx(2.0)


def test_reference_ssd_matches_the_token_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, nh, hd, ns = 2, 12, 3, 4, 5
    x = torch.randn(B, S, nh, hd, generator=g)
    b = torch.randn(B, S, ns, generator=g)
    c = torch.randn(B, S, ns, generator=g)
    dt = torch.rand(B, S, nh, generator=g) * 0.5
    da = -dt * torch.rand(nh, generator=g) * 2
    h = torch.zeros(B, nh, ns, hd)
    ys = []
    for t in range(S):
        h = torch.exp(da[:, t])[..., None, None] * h + torch.einsum(
            "bs,bh,bhd->bhsd", b[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bs,bhsd->bhd", c[:, t], h))
    for Q in (1, 3, 4, 12):
        y, hf = ref.ssd(x, b, c, dt, da, Q)
        torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(hf, h, rtol=1e-5, atol=1e-5)
