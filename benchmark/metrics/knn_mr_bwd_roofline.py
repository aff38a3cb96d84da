"""``knn_mr_bwd_roofline.<kind>``: the ``knn_mr_fused`` backward's share of
its roofline in the traced stretch, in %: the sum over the step's calls of
each call's least time (``benchmark/flops.py``: the larger of its bytes at
3.35 TB/s and its 4*BG*N*k*D operations at the fp32 peak), times the
stretch's steps, over the device time of the kernels that the trace's eager
call attributed to the operator's autograd backward. Nothing where no
kernel was attributed (a step without a backward)."""

from benchmark.flops import knn_mr_backward_bound_s

OPERATOR = ("knn_mr_fused", "bwd")


def read(run, name):
    st, owners = run["stretch"], run["owners"]
    if st is None or name.split(".")[1] != run["kind"]:
        return None
    spent = st.device_seconds({k for k, v in owners.items()
                               if tuple(v) == OPERATOR})
    if spent <= 0.0:
        return None
    bound = sum(knn_mr_backward_bound_s(c, run["dtype"])
                for c in run["knn_calls"])
    return 100.0 * bound * st.items / spent
