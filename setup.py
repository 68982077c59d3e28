"""Package build for gubernator_tpu.

The C++ host runtime (native/host_runtime.cpp) is self-building: the
package compiles it with g++ on first import and falls back to the pure
Python twins when no compiler is present, so no build_ext step is needed
here — the .cpp ships as package data.
"""

from setuptools import find_packages, setup

setup(
    name="gubernator-tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed rate limiting: vectorized token/leaky "
        "buckets over sharded device state with Gubernator-compatible APIs"
    ),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=[
        "gubernator_tpu", "gubernator_tpu.*",
        "gubernator_tpu_torch", "gubernator_tpu_torch.*",
    ]),
    package_data={
        "gubernator_tpu.native": ["host_runtime.cpp"],
        "gubernator_tpu.proto": ["*.proto"],
        # The PyTorch/CUDA port builds these at first use (nvcc, g++).
        "gubernator_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "gubernator_tpu_torch.native": ["host_runtime.cpp"],
        "gubernator_tpu_torch.proto": ["*.proto"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy>=1.26",
        "grpcio>=1.60",
        "protobuf>=4.21",
    ],
    extras_require={
        # kubeconfig-based (out-of-cluster) k8s discovery
        "k8s": ["PyYAML>=6.0"],
    },
    entry_points={
        "console_scripts": [
            "gubernator-tpu=gubernator_tpu.cmd.server:main",
            "gubernator-tpu-cli=gubernator_tpu.cmd.cli:main",
            "gubernator-tpu-cluster=gubernator_tpu.cmd.cluster_main:main",
            "gubernator-tpu-torch=gubernator_tpu_torch.cmd.server:main",
            "gubernator-tpu-torch-cli=gubernator_tpu_torch.cmd.cli:main",
            "gubernator-tpu-torch-cluster=gubernator_tpu_torch.cmd.cluster_main:main",
        ]
    },
)
