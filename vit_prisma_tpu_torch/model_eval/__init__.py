from vit_prisma_tpu_torch.model_eval.zero_shot import (
    zero_shot_classifier, zero_shot_eval, run, accuracy,
    load_classifier, save_classifier,
)
