"""What a run is made of, drawn from its seed on the card: the weights (one
normal draw for every parameter, scaled per leaf), the BatchNorm running
statistics, the images and the labels. The same seed gives the same
tensors; both the program and the reference get them.

Images are smooth random fields: a low-resolution uniform grid, upsampled
bicubically to the full size, plus uniform pixel noise, clipped and
rounded to uint8 NHWC. Neighbouring patches are alike and far ones are
not, so the kNN graphs have structure (white noise would make every patch
as near as any other). How fast the kNN kernels select depends on it.
Labels are multi-hot at the traffic's mean count of classes per image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import PlainGKGNet, bn_names, param_specs


# the last BatchNorm of every residual branch (a Grapher's or an FFN's fc2)
# starts at BRANCH_SCALE times the others' scale, as LayerScale starts
# residual branches small (0.1 down to 1e-6): at unit scale the kNN graphs'
# near ties, which bf16 rounding breaks one way and fp32 the other, compound
# block after block until the bf16 output is no longer fp32's
BRANCH_END = "fc2.1.weight"
BRANCH_SCALE = 0.05


# the generators' streams of one seed
WEIGHTS, STATS, IMAGES, LABELS, CALIBRATION = range(1, 6)


def generator(seed: int, stream: int, device: torch.device
              ) -> torch.Generator:
    """A generator of the run's seed for one use (``stream``), so that the
    weights do not depend on how many images were drawn."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (2 ** 63))


def weights(model: dict, seed: int, device: torch.device
            ) -> tuple[dict, dict]:
    """``(params, stats)``: fp32 parameters and drawn running statistics
    by name (``calibrated_stats`` gives eval-mode ones). Convolutions
    kaiming-normal (fan in), the label projections lecun-normal, the label
    embedding normal(1), the head normal(0.01), the position embedding
    normal(0.02), biases normal(0.02), BN scales 1 + normal(0.1) (times
    BRANCH_SCALE at the end of a residual branch) and shifts normal(0.02);
    running means normal(0.1) and variances
    1 + |normal(0.1)|."""
    specs = param_specs(model)
    sizes = [torch.Size(shape).numel() for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS,
                                                        device),
                       device=device)
    params = {}
    for (name, shape, kind), part in zip(specs, flat.split(sizes)):
        t = part.view(shape)
        if kind == "conv":
            t.mul_((2.0 / t[0].numel()) ** 0.5)
        elif kind == "linear":
            t.mul_(shape[1] ** -0.5)
        elif kind == "head":
            t.mul_(0.01)
        elif kind == "bn_weight":
            t.mul_(0.1).add_(1.0)
            if name.endswith(BRANCH_END):
                t.mul_(BRANCH_SCALE)
        elif kind != "label_embedding":
            t.mul_(0.02)
        params[name] = t
    bns = bn_names(model)
    counts = [c for _, c in bns]
    draws = torch.randn(2 * sum(counts),
                        generator=generator(seed, STATS, device),
                        device=device).mul_(0.1)
    means, variances = draws.split(sum(counts))
    stats = {}
    for (name, _), mean, var in zip(bns, means.split(counts),
                                    variances.split(counts)):
        stats[f"{name}.running_mean"] = mean
        stats[f"{name}.running_var"] = var.abs_().add_(1.0)
    return params, stats


@torch.no_grad()
def calibrated_stats(model: dict, params: dict, imgs: torch.Tensor) -> dict:
    """Running statistics as a trained model's BatchNorms hold them: each
    BN's batch mean and variance in one train-mode forward of the plain
    reference (without DropPath) over ``imgs``, normalized NHWC fp32. With
    them an eval forward keeps its activations at the scale training saw,
    and the scores away from 0 and 1."""
    ref = PlainGKGNet(dict(model, drop_path=0.0), params)
    ref.record = {}
    ref.forward(imgs, train=True)
    return ref.record


def images(n: int, size: int, spec: dict, seed: int, stream: int,
           device: torch.device) -> torch.Tensor:
    """``n`` uint8 NHWC images ``(n, size, size, 3)``: for each ``[res,
    amplitude]`` of ``spec['scales']`` a uniform ``res`` x ``res`` field in
    [-amplitude/2, amplitude/2] upsampled bicubically, summed around 128,
    plus uniform pixel noise of ``spec['noise']`` levels."""
    gen = generator(seed, stream, device)
    img = torch.full((n, 3, size, size), 128.0, device=device)
    for res, amp in spec["scales"]:
        low = (torch.rand((n, 3, res, res), generator=gen, device=device)
               - 0.5) * amp
        img += F.interpolate(low, size=(size, size), mode="bicubic",
                             align_corners=False)
    img += (torch.rand((n, 3, size, size), generator=gen, device=device)
            - 0.5) * spec["noise"]
    return img.clamp_(0.0, 255.0).round_().to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()


def labels(n: int, n_classes: int, per_image: float, seed: int, stream: int,
           device: torch.device) -> torch.Tensor:
    """Multi-hot fp32 labels ``(n, n_classes)``, each class on with
    probability ``per_image / n_classes``."""
    gen = generator(seed, stream, device)
    return (torch.rand((n, n_classes), generator=gen, device=device)
            < per_image / n_classes).float()


def normalize(img: torch.Tensor, norm: dict) -> torch.Tensor:
    """The test pipeline's Normalize: ``(img - mean) * (1 / std)`` in fp32,
    NHWC."""
    mean = torch.tensor(norm["mean"], dtype=torch.float32, device=img.device)
    inv = 1.0 / torch.tensor(norm["std"], dtype=torch.float32,
                             device=img.device)
    return (img.float() - mean) * inv
