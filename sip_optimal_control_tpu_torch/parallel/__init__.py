from .sharding import solve_joint_theta
