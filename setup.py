from setuptools import find_packages, setup

setup(
    name="alphafold2-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas/pjit) protein-structure framework with "
        "the capabilities of lucidrains/alphafold2"
    ),
    # alphafold2_tpu: the JAX package (the reference); alphafold2_tpu_torch:
    # its PyTorch/CUDA port, whose CUDA sources are built at first use
    packages=find_packages(include=("alphafold2_tpu", "alphafold2_tpu.*",
                                    "alphafold2_tpu_torch",
                                    "alphafold2_tpu_torch.*")),
    package_data={"alphafold2_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
    ],
    extras_require={
        "embeds": ["torch", "transformers"],
        "torch": ["torch", "numpy"],
        "test": ["pytest"],
    },
)
