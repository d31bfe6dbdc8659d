"""Datasets (numpy and PIL): the synthetic mech-interp datasets, image
folders, CIFAR-10, captions, the preprocessing transforms, ImageNet's class
names and batching.  The native JPEG pipeline is ``dataloaders.native``,
imported on its own since it builds a library at first use."""

from vit_prisma_tpu_torch.dataloaders.synthetic import (
    CircleDataset, DSpritesDataset, IndexedDataset, InductionDataset,
    PolygenicInductionDataset, numpy_batches, train_test_dataset,
)
from vit_prisma_tpu_torch.dataloaders.conceptual_captions import ConceptualCaptionsLocalDataset
from vit_prisma_tpu_torch.dataloaders.imagenet import (
    ImageFolderDataset, ImageNetValidationDataset,
)
from vit_prisma_tpu_torch.dataloaders.transforms import (
    get_clip_val_transforms, get_model_transforms,
)
from vit_prisma_tpu_torch.dataloaders.imagenet_names import (
    get_imagenet_text_labels, imagenet_index_from_word, load_imagenet100_classes,
    load_imagenet_dict, load_imagenet_emoji,
)
from vit_prisma_tpu_torch.dataloaders.cifar import (
    CIFAR10_CLASSES, get_cifar_transform, load_cifar_10,
)
