"""Whole training step's share of the cards' dense bf16 datasheet peak: the
step's analytic FLOPs (``flops.train_step_flops``, this rank's share of
the samples) over the window's time a step and one card's peak; the mean
over ranks is all ranks' FLOPs over all their cards' peak."""


def read(rec):
    if not rec.get("peaks") or not rec.get("flops_per_unit"):
        return None
    return 100.0 * rec["flops_per_unit"] / rec["unit_s"] / rec["peaks"]["bf16"]
