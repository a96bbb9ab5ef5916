from gns_torch.utils.schema import BUS, GEN, LINE, get_BLG  # noqa: F401
from gns_torch.utils.config import GNSConfig, preset  # noqa: F401
