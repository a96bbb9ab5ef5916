"""gns_torch — the Graph Neural Solver ported to PyTorch and CUDA.

The PyTorch counterpart of gns_tpu (JAX/Pallas on a TPU), written for an
NVIDIA H100. File names follow gns_tpu's, so each module's counterpart is
easy to find; gns_tpu stays the reference the port is tested against. This
package imports torch and never jax or gns_tpu.

Subpackages
-----------
utils     schema, config, case tables, grid preparation, augmentation
ops       segment-sum / gather: the dispatch point, the CUDA kernels K1 / K2
          (csrc/segment.cu) and their plain PyTorch twins; the fused edge
          stage K3 (fused.py, csrc/fused_edge.cu) and the whole-forward
          megakernel K4 (megakernel.py, csrc/megakernel.cu), each with its
          plain twin
physics   the fused physics refresh (parity and paper modes) and the
          unfused compensation, imbalance and line flow it is held against
models    LearningBlock, the GNS module, weight conversion, checkpoints
train     the optimizer, the update step and its CUDA-graph epoch, the
          training loop, checkpoints, metrics, `python -m gns_torch.train`
eval      the slack-angle decode
serve     batched inference (GNSPredictor)

Entry points run on "cuda" unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from gns_torch.utils.config import GNSConfig  # noqa: F401,E402
from gns_torch.utils.schema import BUS, GEN, LINE  # noqa: F401,E402
