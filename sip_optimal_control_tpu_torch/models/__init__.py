from .double_integrator import double_integrator
from .cartpole import cartpole_swingup
from .quadrotor import planar_quadrotor
from .synthetic_chain import synthetic_chain
from .robust_tree import robust_scenario_tree
from .shared_theta import shared_theta_chain
