"""The host data path (counterpart: ``gkgnet_tpu/data``): the COCO
multi-label dataset, its wrappers and samplers, the transform pipelines and
the loader. numpy, PIL and the native ops only: nothing here imports torch,
so the loader's spawned workers start light."""

from gkgnet_tpu_torch.data.coco import CocoMultiLabel, COCO_CLASSES
from gkgnet_tpu_torch.data.wrappers import (
    ClassBalancedDataset,
    ConcatDataset,
    KFoldDataset,
    RepeatDataset,
)
from gkgnet_tpu_torch.data.samplers import (
    DistributedSampler,
    IdInOrderSampler,
    RepeatAugSampler,
)
from gkgnet_tpu_torch.data.loader import DataLoader, build_dataloader
from gkgnet_tpu_torch.data import pipelines
