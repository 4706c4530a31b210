"""k5_fwd_roofline.prefill: the least time the card could take for the traced units'
launches of this kernel (``rooflines/kernels.py``, ``k5_fwd``) over the
device time the profiler gives the kernel's operations, in %."""

PARTS = ("flash_fwd",)


def read(facts):
    cap = facts.get("capture")
    bound = facts.get("kernel_bounds", {}).get("k5_fwd")
    if cap is None or bound is None or not cap.units:
        return None
    sec = cap.device_s(*PARTS)
    if sec <= 0:
        return None
    return 100.0 * bound * cap.units / sec
