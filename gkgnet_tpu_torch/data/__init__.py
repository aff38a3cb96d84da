"""The host data path (counterpart: ``gkgnet_tpu/data``): the COCO and VOC
multi-label datasets, the single-label image list, the wrappers and
samplers, the transform pipelines and the loader. numpy, PIL and the
native ops only: nothing here imports torch, so the loader's spawned
workers start light."""

from gkgnet_tpu_torch.data.coco import CocoMultiLabel, COCO_CLASSES
from gkgnet_tpu_torch.data.single_label import ImageListDataset
from gkgnet_tpu_torch.data.voc import VOC_CLASSES, VOCMultiLabel
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
