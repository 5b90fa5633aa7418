from .zoo import (REGISTRY, AffNet, AffNetFast, AffNetFast2Par,  # noqa: F401
                  AffNetFast4, AffNetFast4Rot, AffNetFast4RotNosc,
                  AffNetFast5Rot, AffNetFast52Rot, AffNetFast52RotL,
                  AffNetFast52RotUp, AffNetFastBias, AffNetFastScale,
                  Descriptor, HardNet, HardNetNarELU, HardTFeatNet, OriNet,
                  OriNetFast, OriNetFast32, PatchNet)
from .convert import params_from_jax, params_to_jax  # noqa: F401
from .handcrafted import (AffineShapeEstimator,  # noqa: F401
                          OrientationDetector)
from .sift import SIFTNet  # noqa: F401
from .dense import AffNetFastFullConv  # noqa: F401
from .yinet import YiNet  # noqa: F401
from . import convert  # noqa: F401
