"""``bwd_ms_per_img.<kind>``: device milliseconds per image, in the traced
stretch, of the train step's backward: the device operations between the
program's ``backward`` span markers (``benchmark/spans.py``), over the
stretch's images. Nothing where the program launches no markers."""

from benchmark.spans import device_seconds


def read(run, name):
    st = run["stretch"]
    if st is None or name.split(".")[1] != run["kind"] or not st.images:
        return None
    spent = device_seconds(st, "backward")
    return None if spent is None else 1e3 * spent / st.images
