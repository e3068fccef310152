"""The step's share of the card's float32 peak: the FLOPs of one step
(convolutions and matrix products, forward and backward, counted by
``FlopCounterMode`` over the frozen reference at the cell's shapes) times
the steps of the unprofiled window, over its seconds, over 67 TFLOP/s
(TF32 is off by the recipe)."""

from benchmark.roofline import peaks


def read(record):
    card = peaks(record["device"]["name"])
    window = record["window"]
    if not card or not record.get("flops_per_step") or not window["steps"]:
        return None
    return 100.0 * record["flops_per_step"] * window["steps"] / window["seconds"] / card["fp32_flops"]
