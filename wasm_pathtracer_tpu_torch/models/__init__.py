from wasm_pathtracer_tpu_torch.models.scene import (  # noqa: F401
    PrimType,
    MatKind,
    SceneBuilder,
    SceneData,
    Material,
)
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays  # noqa: F401
from wasm_pathtracer_tpu_torch.models import scenes  # noqa: F401
