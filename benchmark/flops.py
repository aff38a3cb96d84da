"""The yardstick's arithmetic: the published peaks of one H100 SXM, the
analytic forward FLOPs of GKGNet and the least time of each ``knn_mr`` call.

``model_flops`` is a frozen copy of the port's
``gkgnet_tpu_torch/utils/profiling.model_flops`` (multiply + add = 2; the
stem and downsample 3x3 convs, each block's fc1 / fc2 1x1 convs, the
grouped BasicConv, the 4x FFN, the kNN distance product 2*N*M*C per block
and the label pathway). The operator bounds are frozen copies of the
arithmetic that timed each kernel call alone: a forward call reads x, y
(not when y is x), the fp32 bias table and writes idx and the aggregate,
and takes 2*BG*N*M*D operations at the bf16 dense peak; a backward call
reads x, y, idx and the output gradient and writes gx and gy, with
4*BG*N*k*D operations at the fp32 peak. Its bound is the larger of the two
times. Nothing here imports the program.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"bf16": 2, "fp32": 4}

ARCHS = {
    "t": ((2, 2, 6, 2), (48, 96, 240, 384)),
    "s": ((2, 2, 6, 2), (80, 160, 400, 640)),
    "b": ((2, 2, 18, 2), (128, 256, 512, 1024)),
}
REDUCE_RATIOS = (4, 2, 1, 1)


def model_flops(arch: str, size: int, batch: int = 1, n_classes: int = 80,
                num_gcn: int = 1) -> dict:
    """Forward FLOPs per component, ``per_image_total`` and ``total``
    (times ``batch``)."""
    blocks, channels = ARCHS[arch]
    c0 = channels[0]
    s2, s4 = (size // 2) ** 2, (size // 4) ** 2
    fl = {"stem": 2 * 9 * (3 * (c0 // 2) * s2 + (c0 // 2) * c0 * s4
                           + c0 * c0 * s4)}
    n = s4
    label_flops = 0
    for i, nb in enumerate(blocks):
        c = channels[i]
        if i > 0:
            n //= 4
            fl[f"downsample{i}"] = 2 * 9 * channels[i - 1] * c * n
        r = REDUCE_RATIOS[i]
        m = n // (r * r)
        stage = 0
        for _ in range(nb):
            stage += 2 * n * c * c                     # fc1
            stage += 2 * n * m * c                     # distance product
            stage += 2 * n * (2 * c) * (2 * c) // 4    # BasicConv groups=4
            stage += 2 * n * (2 * c) * c               # fc2
            stage += 16 * n * c * c                    # FFN c->4c->c
        fl[f"stage{i}"] = stage
        lt = 0
        for _ in range(num_gcn if i == len(blocks) - 1 else 1):
            lt += 2 * n_classes * c * c                # fc1
            lt += 2 * n_classes * n * c                # cross distance
            lt += 2 * n_classes * (2 * c) * (2 * c) // 4
            lt += 2 * n_classes * (2 * c) * c          # fc2
            lt += 16 * n_classes * c * c               # FFN
        if i < len(blocks) - 1:
            lt += 2 * n_classes * c * channels[i + 1]  # label projection
        label_flops += lt
    fl["label_path"] = label_flops
    fl["head"] = 2 * n_classes * channels[-1] * 2
    fl["per_image_total"] = sum(fl.values())
    fl["total"] = fl["per_image_total"] * batch
    return fl


def knn_mr_calls(model: dict, batch: int) -> list[dict]:
    """The ``knn_mr_fused`` calls of one forward of a configuration's model
    (``arch``, ``size``, ``k``, ``k_label_gcn``, ``num_group``,
    ``n_classes``, ``num_gcn``) at ``batch``: dicts of ``bg``, ``n``,
    ``m``, ``d``, ``k``, ``dilation``, ``bias`` (the (N, M) fp32 table) and
    ``self`` (y is x)."""
    blocks, channels = ARCHS[model["arch"]]
    k, g = model["k"], model["num_group"]
    bg = batch * g
    n = (model["size"] // 4) ** 2
    calls, grapher = [], 0
    for i, nb in enumerate(blocks):
        if i > 0:
            n //= 4
        r = REDUCE_RATIOS[i]
        d = channels[i] // g
        for _ in range(nb):
            dil = min(grapher // 4 + 1, 49 // k)
            calls.append(dict(bg=bg, n=n, m=n // (r * r), d=d, k=k,
                              dilation=dil, bias=True, self=r == 1))
            grapher += 1
        taps = model.get("num_gcn", 1) if i == len(blocks) - 1 else 1
        for _ in range(taps):
            calls.append(dict(bg=bg, n=model["n_classes"], m=n, d=d,
                              k=model["k_label_gcn"], dilation=1, bias=False,
                              self=False))
    return calls


def knn_mr_forward_bound_s(call: dict, dtype: str = "bf16") -> float:
    """Least seconds of one forward call: max(bytes / HBM, ops / peak)."""
    eb = ITEM_BYTES[dtype]
    bg, n, m, d = call["bg"], call["n"], call["m"], call["d"]
    x = bg * n * d * eb
    nbytes = (x + (0 if call["self"] else bg * m * d * eb)
              + (n * m * 4 if call["bias"] else 0)
              + bg * n * call["k"] * 4 + x)
    ops = 2.0 * bg * n * m * d
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def knn_mr_backward_bound_s(call: dict, dtype: str = "bf16") -> float:
    """Least seconds of one backward call: max(bytes / HBM, ops / fp32
    peak)."""
    eb = ITEM_BYTES[dtype]
    bg, n, m, d, k = call["bg"], call["n"], call["m"], call["d"], call["k"]
    x = bg * n * d * eb
    y = bg * m * d * eb
    nbytes = (x + (0 if call["self"] else y) + bg * n * k * 4
              + x + x + y)  # g, gx, gy
    ops = 4.0 * bg * n * k * d
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["fp32"])
