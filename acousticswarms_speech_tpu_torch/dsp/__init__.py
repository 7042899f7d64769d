from .geometry import TdoaGeometry, build_geometry
from .patch import Patch, hyperbola_area_init, hyperbola_area_sample
