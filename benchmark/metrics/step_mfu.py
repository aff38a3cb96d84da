"""``step_mfu.<kind>``: the whole step's share of the card's bf16 dense
peak (989 TFLOP/s, H100 SXM at 700 W), in %: the frozen analytic forward
FLOPs per image (``benchmark/flops.py``; a train step counts three
forwards, no recomputation) times the window's images, over the window's
seconds."""

from benchmark.flops import PEAK_FLOPS


def read(run, name):
    if name.split(".")[1] != run["kind"] or not run["steps"]:
        return None
    passes = 3 if run["kind"] == "train" else 1
    flops = run["flops_per_image"] * passes * run["images"]
    return 100.0 * flops / run["seconds"] / PEAK_FLOPS["bf16"]
