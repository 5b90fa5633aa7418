from .zoo import (AffNetFast, HardNet, HardTFeatNet, OriNet,  # noqa: F401
                  OriNetFast, OriNetFast32, PatchNet)
from .convert import params_from_jax, params_to_jax  # noqa: F401
