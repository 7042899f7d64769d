from . import metrics, shift
