from .zoo import AffNetFast, HardNet, HardTFeatNet, PatchNet  # noqa: F401
from .convert import params_from_jax, params_to_jax  # noqa: F401
