from oceananigans_torch.utils.units import *  # noqa: F401,F403
from oceananigans_torch.utils.pretty import prettytime, prettysummary  # noqa: F401
