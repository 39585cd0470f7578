"""mujoco_sim_tpu: batched robot simulation on an accelerator.

A from-scratch JAX/XLA framework with the capabilities of the
HoangGiang93/mujoco_sim reference stack (see PARITY.md for the
component-by-component map).
"""

__version__ = "0.1.0"

from mujoco_sim_tpu.engine import (  # noqa: F401
    forward, step, step1, step2, inverse, make_data, put_model, set_const,
    step_with_control,
)
from mujoco_sim_tpu.models.compile import load_model, compile_spec  # noqa: F401
from mujoco_sim_tpu.models.model import (  # noqa: F401
    Model, Data, Option, Contact, JointType, GeomType, EqType, Integrator,
    DisableBit,
)


def load_urdf_model(path: str, **kw):
    from mujoco_sim_tpu.models.urdf import compile_urdf

    return compile_urdf(path, **kw)
