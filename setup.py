from setuptools import find_packages, setup

setup(
    name="vit_prisma_tpu",
    version="0.1.0",
    description=("TPU-native mechanistic-interpretability framework for "
                 "vision transformers and CLIP (JAX/XLA/Pallas/pjit)"),
    packages=find_packages(include=["vit_prisma_tpu", "vit_prisma_tpu.*",
                                    "vit_prisma_tpu_torch",
                                    "vit_prisma_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax", "einops", "torch"],
    package_data={"": ["*.md"], "vit_prisma_tpu.dataloaders": ["data/*.json"],
                  "vit_prisma_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "vit_prisma_tpu_torch.dataloaders": ["data/*.json"]},
)
