from .zoo import (REGISTRY, AffNetFast, HardNet,  # noqa: F401
                  HardTFeatNet, OriNet, OriNetFast, OriNetFast32, PatchNet)
from .convert import params_from_jax, params_to_jax  # noqa: F401
from .handcrafted import (AffineShapeEstimator,  # noqa: F401
                          OrientationDetector)
from .sift import SIFTNet  # noqa: F401
from .dense import AffNetFastFullConv  # noqa: F401
