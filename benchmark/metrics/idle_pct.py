"""``idle_pct.<kind>``: the share of the traced stretch (a bounded run of
the cell's own calls after the window) in which no kernel, copy or set ran
on the card, in %. ``<kind>`` is the traffic's: train, eval or serve."""


def read(run, name):
    st = run["stretch"]
    if st is None or name.split(".")[1] != run["kind"] or not st.window_s:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
