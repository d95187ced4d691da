from .double_integrator import double_integrator
from .cartpole import cartpole_swingup
