"""Simulation parameters: the reference's full YAML surface, without jax.

Field-for-field copy of adaptive_sph_tpu/utils/params.py (every field, enum and
default), plus `params_from_dict`, `load_params` with its update_attributes
merge, `init_h_for_uniform`, the sizing function `optimal_mass_from_level`
and `num_levels_for`. Fields the port does not implement yet are
still parsed; `adaptive_sph_torch.runner.check_supported` rejects them.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import torch
import yaml

from ..ops.kernels import ETA, radius_to_sphere_volume, sphere_volume_to_radius
from ..ops.numerics import div_const


class ViscosityType(str, enum.Enum):
    WCSPH = "WCSPH"
    ApproxLaplace = "ApproxLaplace"
    XSPH = "XSPH"


class NeighborhoodSearchAlgorithm(str, enum.Enum):
    Grid = "Grid"
    RStar = "RStar"  # both map onto the multi-level sorted cell grid


class InitBoundaryHandlerType(str, enum.Enum):
    Particles = "Particles"
    AnalyticUnderestimate = "AnalyticUnderestimate"
    AnalyticOverestimate = "AnalyticOverestimate"
    NoBoundary = "NoBoundary"


class SupportLengthEstimation(str, enum.Enum):
    FromDistribution = "FromDistribution"
    FromDistributionClamped1 = "FromDistributionClamped1"
    FromDistributionClamped2 = "FromDistributionClamped2"
    FromDistribution2 = "FromDistribution2"
    FromMass = "FromMass"


class LevelEstimationMethod(str, enum.Enum):
    NoneMethod = "None"
    CenterDiff = "CenterDiff"
    EmptyAngle = "EmptyAngle"


class PressureSolverMethod(str, enum.Enum):
    IISPH = "IISPH"
    IISPH2 = "IISPH2"
    HybridDFSPH = "HybridDFSPH"
    OnlyDivergence = "OnlyDivergence"


class HybridDfsphDensitySourceTerm(str, enum.Enum):
    DensityAndDivergence = "DensityAndDivergence"
    OnlyDensity = "OnlyDensity"


class OperatorDiscretization(str, enum.Enum):
    ConsistentSimpleGradient = "ConsistentSimpleGradient"
    ConsistentSymmetricGradient = "ConsistentSymmetricGradient"
    Winchenbach2020 = "Winchenbach2020"


class BoundaryPenaltyTerm(str, enum.Enum):
    NoPenalty = "None"
    Linear = "Linear"
    Quadratic1 = "Quadratic1"
    Quadratic2 = "Quadratic2"


class SizingFunction(str, enum.Enum):
    Radius2 = "Radius2"
    Radius = "Radius"
    Mass = "Mass"


class FillStashWith(str, enum.Enum):
    SurfaceDistanceFirstIteration = "SurfaceDistanceFirstIteration"
    SurfaceDistanceMiddle = "SurfaceDistanceMiddle"


class ParticleSizes(str, enum.Enum):
    """Compile-time feature switch of the reference (sph_kernels.rs:14-18)."""

    Uniform = "Uniform"
    Adaptive = "Adaptive"


@dataclasses.dataclass(frozen=True)
class SimulationParams:
    # field-for-field mirror of simulation_parameters.rs:26-108
    rest_density: float = 1.0
    cfl_factor: float = 0.4
    max_dt: float = 0.006
    h: float = 0.0
    use_iisph: bool = True  # parsed-but-unused in the reference too
    viscosity: float = 0.003
    viscosity_type: ViscosityType = ViscosityType.ApproxLaplace
    gravity: float = -9.81
    check_aii: bool = False

    level_estimation_method: LevelEstimationMethod = LevelEstimationMethod.EmptyAngle
    maximum_range: float = 5.0

    jacobi_omega: float = 0.5

    eos_stiffness: float = 80.0  # parsed-but-unused (reference parity)
    eos_power: int = 7  # parsed-but-unused (reference parity)

    neighborhood_search_algorithm: NeighborhoodSearchAlgorithm = NeighborhoodSearchAlgorithm.RStar
    init_boundary_handler: InitBoundaryHandlerType = InitBoundaryHandlerType.AnalyticOverestimate
    support_length_estimation: SupportLengthEstimation = SupportLengthEstimation.FromMass

    sdf_gradient_eps: float = 1e-5

    fail_on_missing_split_pattern: bool = False
    pull_fluid_to: Optional[tuple] = None

    constrain_neighborhood_count: bool = False
    particle_radius_fine: float = 0.005
    particle_radius_base: float = 0.7
    maximum_surface_distance: float = 8.0
    minimum_share_partners: int = 0
    minimum_merge_partners: int = 0
    merging: bool = True
    sharing: bool = True
    splitting: bool = True
    max_mass_transfer_sharing: float = 400000.0
    max_mass_transfer_merging: float = 100.0
    max_share_distance: float = 1.6
    max_merge_distance: float = 1.6
    allow_merge_with_optimal_particle: bool = False
    allow_share_with_optimal_particle: bool = False
    allow_share_with_too_small_particle: bool = False
    allow_merge_on_size_difference: bool = False

    boundary_is_fluid_surface: bool = False
    use_extended_range_for_level_estimation: bool = True

    pressure_solver_method: PressureSolverMethod = PressureSolverMethod.HybridDFSPH
    iisph_max_avg_density_error: float = 0.002
    hybrid_dfsph_factor: float = 0.0
    hybrid_dfsph_max_avg_density_error: float = 0.01
    hybrid_dfsph_max_avg_divergence_error: float = 0.001
    hybrid_dfsph_density_source_term: HybridDfsphDensitySourceTerm = (
        HybridDfsphDensitySourceTerm.DensityAndDivergence
    )
    hybrid_dfsph_non_pressure_accel_before_divergence_free: bool = True

    check_neighborhood: bool = False
    fill_stash_with: Optional[FillStashWith] = None
    boundary_penalty_term: BoundaryPenaltyTerm = BoundaryPenaltyTerm.Quadratic1
    sizing_function: SizingFunction = SizingFunction.Radius

    level_estimation_after_advection: bool = False
    level_estimation_range: float = 5.5

    operator_discretization: OperatorDiscretization = OperatorDiscretization.ConsistentSimpleGradient
    operator_discretization_for_diagonal: Optional[OperatorDiscretization] = None

    max_iters: int = 1000

    # ---- rebuild-side static settings (not in the reference YAML) ----
    particle_sizes: ParticleSizes = ParticleSizes.Adaptive
    # the reference always runs level estimation; its outputs feed only adaptivity
    # (classification targets) and visualization, so the rebuild dead-code-eliminates
    # it when resampling is off — set this to force it (e.g. Distance visualization)
    force_level_estimation: bool = False
    # likewise, the <1> constant-field and per-particle neighbor counts are pure
    # diagnostics (viz attributes); skipped unless requested
    force_diagnostic_fields: bool = False
    # warm-start each pressure solve from the previous step's converged pressure
    # instead of zero (the reference always cold-starts, simulation.rs:1143/1169/1190).
    # Same operator and tolerance contract — the solve still runs to the configured
    # avg-error tolerance with the >=2-iteration rule — but typically several times
    # fewer Jacobi iterations. Off by default for bitwise reference parity.
    warm_start_pressure: bool = False
    # heavy-ball momentum on the relaxed-Jacobi PPE sweeps (second-order
    # Richardson): p <- clamp(p + omega*(s - Ap)/aii + momentum*(p - p_prev)).
    # Same operator, same source terms, same exit test (>=2 iterations,
    # |avg predicted error| < tol, simulation.rs:1453-1469) and the same
    # negative-pressure projection — only the relaxation SCHEDULE differs, so
    # every converged solve still satisfies the reference's tolerance contract
    # against the same PPE. Cuts the Jacobi iteration count several-fold on
    # stiff solves (the reference's plain omega=0.5 Jacobi is the
    # momentum=0 special case). 0.0 = reference schedule (default).
    jacobi_momentum: float = 0.0
    # store the per-step pair weights and viscosity pair factors (the CSR
    # pair list of ops/pair_ops.py) as bfloat16 instead of f32: halves the
    # bytes every Jacobi matvec streams. The pair weights round to ~0.4%
    # relative, which perturbs the operator slightly (the solve still
    # converges to ITS tolerance against the rounded operator); sums
    # accumulate in f32. Off by default — f32 matches the reference numerics.
    weight_cache_bf16: bool = False
    # the JAX package's whole-solve resident kernels; not ported yet
    resident_solver: bool = False
    # per-stage timing sections in the .stat dump (JAX package only so far)
    profile_stages: bool = False

    def level_estimation_active(self) -> bool:
        if self.level_estimation_method == LevelEstimationMethod.NoneMethod:
            return False
        if self.particle_sizes == ParticleSizes.Uniform:
            return self.force_level_estimation
        return (
            self.merging or self.sharing or self.splitting or self.force_level_estimation
        )

    def mass_fine(self, dim: int = 2) -> float:
        """simulation_parameters.rs:125-127."""
        return float(radius_to_sphere_volume(self.particle_radius_fine, dim)) * self.rest_density

    def mass_base(self, dim: int = 2) -> float:
        """simulation_parameters.rs:129-131."""
        return float(radius_to_sphere_volume(self.particle_radius_base, dim)) * self.rest_density

    def gravity_vector(self, dim: int = 2) -> tuple:
        """simulation_parameters.rs:133-145: gravity acts on the y axis."""
        if dim == 2:
            return (0.0, self.gravity)
        return (0.0, self.gravity, 0.0)

    def replace(self, **kw) -> "SimulationParams":
        return dataclasses.replace(self, **kw)


_ENUM_FIELDS = {
    "viscosity_type": ViscosityType,
    "neighborhood_search_algorithm": NeighborhoodSearchAlgorithm,
    "init_boundary_handler": InitBoundaryHandlerType,
    "support_length_estimation": SupportLengthEstimation,
    "level_estimation_method": LevelEstimationMethod,
    "pressure_solver_method": PressureSolverMethod,
    "hybrid_dfsph_density_source_term": HybridDfsphDensitySourceTerm,
    "operator_discretization": OperatorDiscretization,
    "operator_discretization_for_diagonal": OperatorDiscretization,
    "boundary_penalty_term": BoundaryPenaltyTerm,
    "sizing_function": SizingFunction,
    "fill_stash_with": FillStashWith,
    "particle_sizes": ParticleSizes,
}

_INT_FIELDS = {"eos_power", "minimum_share_partners", "minimum_merge_partners", "max_iters"}


def params_from_dict(d: dict) -> SimulationParams:
    """Build SimulationParams from a parsed YAML mapping (reference field names)."""
    known = {f.name for f in dataclasses.fields(SimulationParams)}
    kw = {}
    for k, v in d.items():
        if k not in known:
            raise KeyError(f"unknown simulation parameter: {k}")
        if v is None:
            kw[k] = None
        elif k in _ENUM_FIELDS:
            kw[k] = _ENUM_FIELDS[k](str(v))
        elif k in _INT_FIELDS:
            kw[k] = int(v)
        elif k == "pull_fluid_to":
            kw[k] = tuple(float(x) for x in v) if v is not None else None
        elif isinstance(getattr(SimulationParams, k, None), bool) or isinstance(v, bool):
            kw[k] = bool(v)
        else:
            kw[k] = v
    return SimulationParams(**kw)


def load_params(path: str, overwrite_path: Optional[str] = None, update_attributes: Optional[dict] = None) -> SimulationParams:
    """YAML load + key-level merge layers (main_loop.rs:105-126, animation/mod.rs:89-99)."""
    with open(path) as f:
        d = yaml.safe_load(f)
    if overwrite_path is not None:
        with open(overwrite_path) as f:
            over = yaml.safe_load(f)
        for k, v in over.items():
            if k not in d:
                raise KeyError(f"not able to find attribute {k}")
            d[k] = v
    if update_attributes:
        valid = {f.name for f in dataclasses.fields(SimulationParams)}
        for k, v in update_attributes.items():
            # the reference requires k to pre-exist in the base YAML
            # (animation/mod.rs:94-95), which makes several of its own media
            # configs unusable (e.g. media/surface-distance.yaml sets
            # fill_stash_with, absent from default-config.yaml); accept any
            # valid SimulationParams field instead, still rejecting typos
            if k not in d and k not in valid:
                raise KeyError(f"not able to find attribute {k}")
            d[k] = v
    return params_from_dict(d)


def init_h_for_uniform(params: SimulationParams, block0_spacing: float, block0_fill: float) -> SimulationParams:
    """Uniform h from the block-0 spacing (adaptive sizes keep h = 0)."""
    if params.particle_sizes == ParticleSizes.Adaptive:
        return params.replace(h=0.0)
    v = block0_spacing * block0_spacing * block0_fill
    h = ETA * float(sphere_volume_to_radius(v, 2))
    return params.replace(h=h)


def optimal_mass_from_level(level: torch.Tensor, params: SimulationParams, dim: int = 2):
    """Sizing function: target mass from the (negative) surface distance.
    Callers map "no level" to -maximum_surface_distance themselves."""
    msd = float(params.maximum_surface_distance)
    level = torch.clamp(level, min=-msd)
    interpolation = div_const(level, -msd)  # in [0, 1]
    if params.sizing_function == SizingFunction.Mass:
        return (params.mass_fine(dim) * (1.0 - interpolation)
                + params.mass_base(dim) * interpolation)
    if params.sizing_function == SizingFunction.Radius:
        target_radius = (params.particle_radius_fine * (1.0 - interpolation)
                         + params.particle_radius_base * interpolation)
        return radius_to_sphere_volume(target_radius, dim) * params.rest_density
    if params.sizing_function == SizingFunction.Radius2:
        ip = interpolation ** (1.0 / dim)
        target_radius = params.particle_radius_fine * (1.0 - ip) + params.particle_radius_base * ip
        return radius_to_sphere_volume(target_radius, dim) * params.rest_density
    raise ValueError(params.sizing_function)


def num_levels_for(params: SimulationParams) -> int:
    """Static level count of the multi-level grid."""
    if params.particle_sizes == ParticleSizes.Uniform:
        return 1
    ratio = max(params.particle_radius_base / max(params.particle_radius_fine, 1e-12), 1.0)
    return min(int(math.ceil(math.log2(ratio))) + 2, 12)
