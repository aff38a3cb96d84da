"""``dense_ms_per_img.<kind>``: device milliseconds per image, in the
traced stretch, of every device operation that no registered operator of
the port launched (BN, convolutions, elementwise work, layout copies, the
optimizer): all device time less the kernels the trace's eager call
attributed to an operator, over the stretch's images."""


def read(run, name):
    st, owners = run["stretch"], run["owners"]
    if st is None or name.split(".")[1] != run["kind"] or not st.images:
        return None
    dense = st.device_seconds() - st.device_seconds(set(owners))
    return 1e3 * dense / st.images
