from gns_torch.eval.newton_raphson import NRResult, newton_raphson_pf  # noqa: F401
from gns_torch.eval.solve import solve_ac  # noqa: F401
from gns_torch.eval.dcpf import solve_batched_dc  # noqa: F401
from gns_torch.eval.fdpf import solve_batched_fdpf  # noqa: F401
