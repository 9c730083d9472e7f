"""pharmsol-tpu: a JAX PK/PD simulation engine.

A ground-up JAX/XLA rebuild of the capabilities of LAPKB/pharmsol
(reference mounted at /root/reference): closed-form analytical models,
event-segmented ODE integration, particle-filtered SDEs, population
likelihood matrices, NCA, and a runtime model DSL — redesigned around
static event grids, ``lax.scan``, ``vmap`` over subjects × support points,
and ``jax.sharding`` device meshes instead of the reference's dynamic
per-subject Rust event loop with rayon threads.
"""

from . import config  # noqa: F401  (enables x64 on import)
from .config import float_dtype, set_float_dtype  # noqa: F401
from .data.builder import SubjectBuilder  # noqa: F401
from .data.covariate import Covariate, Covariates  # noqa: F401
from .data.error_model import (  # noqa: F401
    AssayErrorModel,
    AssayErrorModels,
    ErrorPoly,
    Factor,
)
from .data.event import (  # noqa: F401
    AUCMethod,
    BLQRule,
    Bolus,
    Censor,
    Infusion,
    InputLabel,
    Observation,
    OutputLabel,
    Route as AdminRoute,
)
from .data.residual_error import ResidualErrorModel, ResidualErrorModels  # noqa: F401
from .data.serde import from_json, load_json, save_json, to_json  # noqa: F401
from .data.structs import Data, Occasion, Subject  # noqa: F401
from .errors import PharmsolError  # noqa: F401
from .metadata import (  # noqa: F401
    AnalyticalKernel,
    CovariateDecl,
    ModelKind,
    ModelMetadata,
    Route,
    RouteKind,
    ValidatedModelMetadata,
)
from .metadata import new as metadata_new  # noqa: F401
from .models.equation import ODE, Analytical, EquationBase  # noqa: F401
from .models.declarative import analytical_model, ode_model, sde_model  # noqa: F401
from .optimize import ParameterOptimizer, get_e2  # noqa: F401
from .parameters import ParameterOrder, Parameters, dense  # noqa: F401

from . import nca  # noqa: F401  (attaches .nca/.superposition/metrics methods)
from .engine import analytical as kernels  # noqa: F401
from .engine.analytical import (  # noqa: F401
    one_compartment,
    one_compartment_cl,
    one_compartment_cl_with_absorption,
    one_compartment_with_absorption,
    three_compartments,
    three_compartments_cl,
    three_compartments_cl_with_absorption,
    three_compartments_with_absorption,
    two_compartments,
    two_compartments_cl,
    two_compartments_cl_with_absorption,
    two_compartments_with_absorption,
)

__version__ = "0.1.0"


class metadata:  # noqa: N801 - namespace shim: pharmsol::metadata::new parity
    new = staticmethod(metadata_new)
    from .metadata import Route, CovariateDecl  # noqa: F401


def __getattr__(name):
    if name == "SDE":
        from .models.sde import SDE as _SDE

        return _SDE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + ["SDE"])
