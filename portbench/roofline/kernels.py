"""How the port's hand-written kernels show in a device trace.

One call of a kernel wrapper (``repro_torch.kernels.ops.<wrapper>``,
whose ``launches`` counts the calls) launches several device kernels.
``SIGNATURE`` names, per wrapper, the one kernel that every call launches
exactly once, so the trace's count of it must equal the wrapper's count
over the same window; ``PARTS`` names every kernel of a call, whose times
sum to the call's device time.  The SSD gradient shares its state pass
(``ssd_pass_kernel``) with the forward: the pass that runs right after the
gradient's recomputed chunk pass (``ssd_state_*<float, false>``: the
gradient runs with float32 step sizes) on the same stream is the
gradient's."""

from __future__ import annotations

WRAPPERS = ("paged_attention", "rmsnorm", "flash_attention", "ssd_scan",
            "ssd_scan_bwd")

SIGNATURE = {
    "paged_attention": r"paged_split",
    "ssd_scan_bwd": r"ssd_grad_(bf16|f32)",
    "ssd_scan": r"ssd_out_(bf16|f32)",
}

PARTS = {
    "paged_attention": r"paged_(split|combine)",
    "ssd_scan_bwd": r"ssd_state_(bf16|f32)<float, (false|true)>"
                    r"|ssd_rpass_kernel|ssd_grad_(bf16|f32)|ssd_bwd_finish",
}
FOLLOWING = {"ssd_scan_bwd": r"ssd_state_(bf16|f32)<float, false>"}

# counters that grow when something is traced, compiled or captured
COMPILE_COUNTERS = ("retraces", "segments_recompiled", "graph_versions",
                    "capture.graphs", "capture.recaptures",
                    "capture.warmups")


def device_time(trace, wrapper: str) -> float:
    """Seconds of device time of every kernel of ``wrapper``'s calls."""
    t = trace.kernel_time(PARTS[wrapper])
    if wrapper in FOLLOWING:
        t += sum(e - s for _, s, e, _ in trace.following(FOLLOWING[wrapper]))
    return t


def check_counts(trace, delta: dict, wrappers) -> None:
    """Raise unless the trace holds each wrapper's signature kernel as
    many times as the wrapper counted launches in the window."""
    for w in wrappers:
        seen = trace.kernel_count(SIGNATURE[w])
        launched = delta["launch." + w]
        if seen != launched:
            raise RuntimeError(
                f"the trace holds {seen} {w} kernels, the program "
                f"launched {launched} in the window")
