from .settings import LineSearchSettings, LoggingSettings, Settings, SIPStatus
from .sip import (ModelEval, OCProblem, Primal, SolveResult, YVec, ZVec,
                  solve)
