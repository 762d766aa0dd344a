"""server_mix_roofline (server plane, ``kernels/server_plane.py``,
``csrc/server_plane.cu``): the sum of the bounds over the sum of the
kernel times of every server_mix launch in the trace. A launch mixes
one dtype group of the parameters (the kernel's template argument):
its bound is its bytes, K client rows and prev read and the new model
written, over HBM bandwidth."""
import re

from portbench import counts

_KERNEL = r"\bserver_mix(_vec)?_kernel<([^>]*)>"
_DTYPE = {"float": "float32", "__nv_bfloat16": "bfloat16",
          "nv_bfloat16": "bfloat16", "__half": "float16"}


def read(run):
    if run.trace is None:
        return None
    groups = counts.params_by_dtype(run.cfg)
    K = run.traffic["cohorts"]
    bound = spent = 0.0
    for e in run.trace.kernels(_KERNEL):
        arg = re.search(_KERNEL, e["name"]).group(2).strip()
        dtype = _DTYPE.get(arg.split("::")[-1])
        if dtype not in groups:
            return None
        bound += counts.server_mix_bytes(K, groups[dtype], dtype) \
            / counts.HBM_BYTES
        spent += e["dur"] / 1e6
    return 100.0 * bound / spent if spent else None
