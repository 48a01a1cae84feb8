from steppingstone_tpu_torch.physics.robots import cassie as _cassie_mod
from steppingstone_tpu_torch.physics.robots import walker3d as _walker3d_mod

REGISTRY = {
    "walker3d": _walker3d_mod.walker3d,
    "mike": _walker3d_mod.mike,
    "cassie": _cassie_mod.cassie,
}
