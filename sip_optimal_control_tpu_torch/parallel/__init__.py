from .._mesh import ScenarioMesh
from .sharding import (BatchSolveStats, scenario_mesh, shard_scenarios,
                       solve_batch_sharded, solve_joint_theta)
