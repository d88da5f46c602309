"""The SSD chunk scan's backward kernel: its least time from shapes over
its device time in the profiled training steps.

The least time is the larger of twice the forward's operations at the f32
rate of the CUDA cores (the kernel computes in f32 FMAs; the chunk states
it recomputes are not counted, as no count of ``counts.py`` counts a
recompute) and its bytes at the memory's rate: x, dy and dx like x; b, c,
db and dc like b; dt, da, ddt and dda in f32.  A program without the
kernel launches no ``ssd_scan_bwd`` and the metric reads nothing."""

from portbench.profiler import kernel_seconds
from portbench.reference.model import chunk_len
from portbench.roofline import counts, shares

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"

# the device kernels of one ssd_scan_bwd call
KERNELS = ("ssdbwd_",)


def bwd_counts(ctx):
    """(operations, bytes) of one backward call at the cell's shapes."""
    m, mix = ctx["cell"]["model"], ctx["cell"]["mix"]
    B, S = mix["batch"], mix["seq_len"]
    Q = chunk_len(S, m["ssm_chunk"])
    hd, ns = m["ssm_head_dim"], m["ssm_state"]
    nh = m["ssm_expand"] * m["d_model"] // hd
    elem = 2 if m["dtype"] == "bfloat16" else 4
    flops, _ = counts.ssd_scan(B, S // Q, Q, nh, hd, ns, elem)
    T = B * S
    nbytes = 3 * T * nh * hd * elem + 4 * T * ns * elem + 4 * T * nh * 4
    return 2.0 * flops, float(nbytes)


def read(ctx):
    prof, pk = ctx["profile"], shares.card_peaks(ctx)
    if not prof or pk is None:
        return None
    calls = prof.get("launches", {}).get("ssd_scan_bwd", 0)
    secs = kernel_seconds(prof, KERNELS)
    if not calls or secs <= 0:
        return None
    flops, nbytes = bwd_counts(ctx)
    return 100.0 * calls * counts.min_time(flops, nbytes, pk, "f32") / secs
