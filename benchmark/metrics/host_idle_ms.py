"""``host_idle_ms.<kind>``: milliseconds per call, in the traced stretch,
in which no device operation ran while a host range of the program
(``gkgnet.*``: the step calls, their preparation, the input's copy or
normalize, the graph's checks, copies and replay) was open
(``benchmark/spans.py``). Nothing where the program opens no such
range."""

from benchmark.spans import host_idle_seconds


def read(run, name):
    st = run["stretch"]
    if st is None or name.split(".")[1] != run["kind"] or not st.items:
        return None
    idle = host_idle_seconds(st)
    return None if idle is None else 1e3 * idle / st.items
