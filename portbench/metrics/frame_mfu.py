"""Whole frame's share of the card's float32 datasheet peak (the frame
runs in float32 with TF32 off): the FLOPs a frame of the window needs, as
the benchmark's own reference counts them rendering the traffic's set
(``entries/relight_frame.py``, ``Entry.unit_flops``), over the window's
time a frame."""


def read(rec):
    if not rec.get("peaks") or not rec.get("flops_per_unit"):
        return None
    return 100.0 * rec["flops_per_unit"] / rec["unit_s"] / rec["peaks"]["fp32"]
