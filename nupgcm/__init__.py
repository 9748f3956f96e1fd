"""nupgcm: planetary-geostrophic ocean model in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference nuPGCM (hgpeterson/nuPGCM): continuous-Galerkin P2-P1
Taylor-Hood finite elements on unstructured tri/tet meshes solving the
nondimensional PG equations -- a rotating-Stokes inversion (GMRES) and
an implicit-diffusion / explicit-advection buoyancy evolution (CG) --
with the entire timestep fused into jitted device code.
"""

import os

# Where compiled executables persist when JAX_COMPILATION_CACHE_DIR is
# unset: one fixed, git-ignored path inside the checkout.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache():
    """Keep JAX's persistent compilation cache where
    ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that variable itself),
    and otherwise at ``CACHE_DIR``: the fused step takes minutes to
    compile and is reusable across runs, and a fixed path is what lets
    a later run find it."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()

from .models.config import (
    ConvectionParameterization,
    EddyParameterization,
    Forcings,
    Parameters,
    SurfaceDirichletBC,
    SurfaceFluxBC,
)
from .models.fedata import FEData, Spaces
from .models.model import BlowUpError, PGModel, State
from .models.timesteppers import BDF1, BDF2
from .mesh.core import Mesh
from .mesh.gmsh_reader import read_msh
from .mesh.writer import write_msh
from .mesh import generators
from .utils.timing import memory_status, print_memory_status
from . import plotting, postprocess

__version__ = "0.1.0"
__all__ = [
    "Parameters", "Forcings", "SurfaceDirichletBC", "SurfaceFluxBC",
    "ConvectionParameterization", "EddyParameterization",
    "Spaces", "FEData", "PGModel", "State", "BlowUpError",
    "BDF1", "BDF2", "Mesh", "read_msh", "write_msh", "generators",
    "plotting", "postprocess", "memory_status", "print_memory_status",
]
