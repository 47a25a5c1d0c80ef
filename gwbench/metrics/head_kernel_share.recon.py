"""Share (%) of the traced window's forwards whose head ran on the U-Net's
head kernel: the program's counter ``unet_head`` times the architecture's
K1 launches a forward (``kernel_shapes``' ``k1``), over ``conv_gn_silu``
(``launch_counts()``); None where the program keeps no such counter or K1
did not run."""
from gwbench import arch
from gwbench.metrics._shared import is_serving


def read(run):
    tr = run.get("trace")
    if not tr or not is_serving(run):
        return None
    k1 = tr["launches"].get("conv_gn_silu", 0)
    head = tr["launches"].get("unet_head")
    if head is None or k1 <= 0:
        return None
    cfg = run["config"]
    model = cfg["model"]
    per = len(arch.of(model).kernel_shapes(model, cfg["segment_len"],
                                           run["rows_per_forward"])["k1"])
    return 100.0 * head * per / k1
