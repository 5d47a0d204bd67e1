"""Model zoo + factory: the batched sweep engines and the per-expert models.

`get_model(name)` mirrors gpsat_tpu.models.get_model (reference factory:
GPSat/models/__init__.py:3-28). Reference model names are accepted as aliases
so existing configs keep working: GPflowGPRModel -> GPRModel,
GPflowSGPRModel -> SGPRModel, and so on.
"""

from gpsat_tpu_torch.models.base import BaseGPRModel  # noqa: F401
from gpsat_tpu_torch.models.batched import BatchedGPR  # noqa: F401


def get_model(name):
    """Map a model name string to a model class."""
    from gpsat_tpu_torch.models.asvgp import ASVGPModel
    from gpsat_tpu_torch.models.exact_gpr import GPRModel
    from gpsat_tpu_torch.models.kiss_gpr import KISSGPModel
    from gpsat_tpu_torch.models.multioutput import (MultioutputGPRModel,
                                                    MultioutputSVGPModel)
    from gpsat_tpu_torch.models.sgpr import SGPRModel
    from gpsat_tpu_torch.models.svgp import SVGPModel
    from gpsat_tpu_torch.models.vff import VFFModel

    registry = {
        "GPRModel": GPRModel,
        "SGPRModel": SGPRModel,
        "SVGPModel": SVGPModel,
        "VFFModel": VFFModel,
        "ASVGPModel": ASVGPModel,
        "KISSGPModel": KISSGPModel,
        "MultioutputGPRModel": MultioutputGPRModel,
        "MultioutputSVGPModel": MultioutputSVGPModel,
        # reference-name aliases (config compatibility)
        "GPflowGPRModel": GPRModel,
        "GPflowSGPRModel": SGPRModel,
        "GPflowSVGPModel": SVGPModel,
        "GPflowVFFModel": VFFModel,
        "GPflowASVGPModel": ASVGPModel,
        "PurePythonGPR": GPRModel,
        "sklearnGPRModel": GPRModel,
        "GPyTorchGPRModel": GPRModel,
        "GPyTorchKISSGPModel": KISSGPModel,
    }
    if name in registry:
        return registry[name]
    raise NotImplementedError(
        f"model: {name} is not implemented; available: {sorted(registry)}")
