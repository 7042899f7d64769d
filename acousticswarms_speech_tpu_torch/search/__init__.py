from .spotform import (
    DelayAndSumExecutor,
    SeparationInference,
    SpotformExecutor,
    SweepLane,
    SweepResult,
)
from .srp_pruning import SrpEngine
