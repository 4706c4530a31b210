"""k6_bwd_roofline.train: the least time the card could take for the traced units'
launches of this kernel (``rooflines/kernels.py``, ``k6_bwd``) over the
device time the profiler gives the kernel's operations, in %."""

PARTS = ("ss_bwd_kernel",)


def read(facts):
    cap = facts.get("capture")
    bound = facts.get("kernel_bounds", {}).get("k6_bwd")
    if cap is None or bound is None or not cap.units:
        return None
    sec = cap.device_s(*PARTS)
    if sec <= 0:
        return None
    return 100.0 * bound * cap.units / sec
