from .common import normalize_input, unnormalize_input
from .localization import SpotNet
from .separation import SepNet
from .weights import from_jax_params, load_release
