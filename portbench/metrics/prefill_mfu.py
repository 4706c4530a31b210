"""prefill_mfu: a request's model FLOPs (``flops/lm.py::prefill_request``)
over its wall time in the untraced window, as a share of the card's bf16
peak, in %."""


def read(facts):
    wall = facts.get("unit_wall_s")
    if not wall:
        return None
    return 100.0 * facts["flops_per_unit"] / wall / facts["peak_flops"]
