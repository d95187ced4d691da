"""sip_optimal_control_tpu_torch — the PyTorch + CUDA port.

A port of ``sip_optimal_control_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100: the stagewise interior-point
solver, the dual-regularized chain-LQR Riccati factor/solve, KKT
condensation, the autodiff model front door and batched warm-started MPC.
The scenario batch is an explicit leading axis of every tensor.  This
package never imports JAX; the JAX package is the reference its tests hold
it to.
"""

from .types import (Dimensions, DimensionError, FactorStatus,
                    InputValidationStatus, Topology, TopologyError,
                    TopologySchedule, compile_topology, try_compile_topology,
                    validate_input)
from .ops.lqr import (LQRData, LQRFactorization, LQRSolution, lqr_factor,
                      lqr_factor_solve, lqr_residual_norm, lqr_solve)
from .solver import (OCProblem, Primal, Settings, SIPStatus, SolveResult,
                     YVec, ZVec, solve)
from .model import ModelSpec, box_bounds, build_problem
from .mpc import MPCSteps, mpc_steps
from .interop import from_jax_numpy

__version__ = "0.1.0"
