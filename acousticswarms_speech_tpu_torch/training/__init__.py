from .datasets import BatchLoader, LocalizationDataset, SeparationDataset
from .experiment import load_model_from_exp, read_description
from .losses import get_loss_fn
from .schedulers import ReduceLROnPlateau
