"""Supervised ViT training (PyTorch port of ``vit_prisma_tpu.training``)."""

from vit_prisma_tpu_torch.training.trainer import (
    EarlyStopping, PrismaCallback, TrainerConfig, TrainState, calculate_accuracy,
    calculate_loss, make_eval_fns, make_train_step, train,
)
