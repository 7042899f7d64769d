from .joint import JointPipeline
from .mic_array import MicArray
