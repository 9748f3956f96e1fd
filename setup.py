from setuptools import find_packages, setup

setup(
    name="nupgcm",
    version="0.1.0",
    description="Planetary-geostrophic ocean model in JAX (P2-P1 finite elements)",
    packages=find_packages(include=["nupgcm", "nupgcm.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
)
