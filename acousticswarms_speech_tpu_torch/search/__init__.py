from .spotform import (
    DelayAndSumExecutor,
    SeparationInference,
    SpotformExecutor,
    SweepResult,
)
from .srp_pruning import SrpEngine
