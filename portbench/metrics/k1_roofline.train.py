"""k1_roofline.train: the least time the card could take for the traced units'
launches of this kernel (``rooflines/kernels.py``, ``k1``) over the
device time the profiler gives the kernel's operations, in %."""

PARTS = ("fused_server_kernel",)


def read(facts):
    cap = facts.get("capture")
    bound = facts.get("kernel_bounds", {}).get("k1")
    if cap is None or bound is None or not cap.units:
        return None
    sec = cap.device_s(*PARTS)
    if sec <= 0:
        return None
    return 100.0 * bound * cap.units / sec
