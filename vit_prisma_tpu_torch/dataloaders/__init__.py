"""Datasets (numpy only): the synthetic mech-interp datasets and batching."""

from vit_prisma_tpu_torch.dataloaders.synthetic import (
    CircleDataset, DSpritesDataset, IndexedDataset, InductionDataset,
    PolygenicInductionDataset, numpy_batches, train_test_dataset,
)
