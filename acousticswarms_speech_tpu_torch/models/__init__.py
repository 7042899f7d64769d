from .common import normalize_input, unnormalize_input
from .factory import create_model, init_model, param_count, rescale_params
from .localization import SpotNet
from .separation import SepNet
from .weights import from_jax_params, load_release
