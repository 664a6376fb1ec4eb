"""Package build (reference: setup.py driving CMake — here the native
control-plane lib builds lazily via horovod_tpu/native/Makefile at first
use, so the Python package is pure at install time)."""

from setuptools import find_packages, setup

setup(
    name="horovod-tpu",
    version="0.1.0",
    description="TPU-native distributed training framework with the "
                "capabilities of Horovod",
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax", "pyyaml"],
    extras_require={
        "spark": ["pyspark"],
        "ray": ["ray"],
        # estimator stack (parquet shards + fsspec stores)
        "estimator": ["pyarrow", "fsspec", "pandas"],
        # multi-NIC discovery (falls back to the default route without it)
        "net": ["psutil"],
    },
    entry_points={
        "console_scripts": [
            "horovodrun-tpu = horovod_tpu.runner.launch:main",
        ],
    },
    package_data={"horovod_tpu.native": ["Makefile", "src/*.cc"],
                  # the port's CUDA kernels build from these at first use
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  # hvdlint's checked-in (empty) baseline for the port
                  "horovod_tpu_torch.analysis": ["hvdlint_baseline.json"]},
)
