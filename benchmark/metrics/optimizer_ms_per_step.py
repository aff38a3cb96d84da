"""``optimizer_ms_per_step.<kind>``: device milliseconds per step, in the
traced stretch, of the train step's optimizer (global-norm clip and
AdamW): the device operations between the program's ``optimizer`` span
markers (``benchmark/spans.py``), over the stretch's steps. Nothing where
the program launches no markers."""

from benchmark.spans import device_seconds


def read(run, name):
    st = run["stretch"]
    if st is None or name.split(".")[1] != run["kind"] or not st.items:
        return None
    spent = device_seconds(st, "optimizer")
    return None if spent is None else 1e3 * spent / st.items
