"""Fixed tendons vs the oracle: length/velocity/moment, spring (incl. 3.x
deadband springlength), damper, limit rows, tendon actuator transmission.

The reference's libmujoco backend exposes the full <tendon> surface for
arbitrary user worlds (SURVEY §2.2); fixed tendons are a static linear form
W qpos, so the whole stage is two constant matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mujoco

from mujoco_sim_tpu import engine
from mujoco_sim_tpu.models.compile import compile_spec
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string

ARM = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0" mass="0.4"/>
        <body pos="0.25 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.2"/>
          <geom type="sphere" size="0.03" mass="0.2"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
{tendons}
  </tendon>
  <actuator>
{actuators}
  </actuator>
</mujoco>
"""

TENDONS = """
    <fixed name="t1" stiffness="25" damping="1.5" springlength="0.05">
      <joint joint="j1" coef="1.0"/>
      <joint joint="j2" coef="-0.7"/>
    </fixed>
    <fixed name="t2" limited="true" range="-0.15 0.2" solreflimit="0.01 1">
      <joint joint="j2" coef="0.5"/>
      <joint joint="j3" coef="2.0"/>
    </fixed>
"""


def _pair(xml):
    mo = mujoco.MjModel.from_xml_string(xml)
    do = mujoco.MjData(mo)
    m = engine.set_const(compile_spec(parse_mjcf_string(xml)))
    d = engine.make_data(m)
    return mo, do, m, d


def test_tendon_forward_oracle():
    xml = ARM.format(tendons=TENDONS,
                     actuators='<general name="at" tendon="t1" gear="1.7" '
                               'gainprm="3.0"/>')
    mo, do, m, d = _pair(xml)
    qs, vs, cs = [0.4, -0.25, 0.12], [0.5, -0.3, 0.2], [0.8]
    do.qpos[:] = qs
    do.qvel[:] = vs
    do.ctrl[:] = cs
    mujoco.mj_forward(mo, do)
    d = d.replace(qpos=jnp.asarray(qs, d.qpos.dtype),
                  qvel=jnp.asarray(vs, d.qpos.dtype),
                  ctrl=jnp.asarray(cs, d.qpos.dtype))
    d = engine.forward(m, d)
    np.testing.assert_allclose(np.asarray(m.ten_invweight0),
                               mo.tendon_invweight0, rtol=1e-9)
    for mine, orc in [(d.ten_length, do.ten_length),
                      (d.ten_velocity, do.ten_velocity),
                      (d.actuator_length, do.actuator_length),
                      (d.actuator_velocity, do.actuator_velocity),
                      (d.qfrc_spring, do.qfrc_spring),
                      (d.qfrc_damper, do.qfrc_damper),
                      (d.qfrc_actuator, do.qfrc_actuator)]:
        np.testing.assert_allclose(np.asarray(mine), orc, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.qacc), do.qacc, atol=1e-9)


def test_tendon_limit_trajectory():
    """300 steps with the t2 limit actively engaged at the end."""
    xml = ARM.format(tendons=TENDONS,
                     actuators='<general name="at" tendon="t1" gear="1.7" '
                               'gainprm="3.0"/>')
    mo, do, m, d = _pair(xml)
    do.ctrl[:] = [0.8]
    d = d.replace(ctrl=jnp.asarray([0.8], d.qpos.dtype))
    step = jax.jit(engine.step)
    engaged = 0
    for _ in range(300):
        mujoco.mj_step(mo, do)
        d = step(m, d)
        engaged = max(engaged, int(do.nefc))
    assert engaged > 0, "limit should engage during this rollout"
    assert np.abs(do.qpos - np.asarray(d.qpos)).max() < 1e-8
    assert np.abs(do.ten_length - np.asarray(d.ten_length)).max() < 1e-8


def test_deadband_springlength():
    """two-element springlength is a deadband spring (MuJoCo 3.x)."""
    tns = """
    <fixed name="db" stiffness="40" springlength="0.1 0.3">
      <joint joint="j1" coef="1"/>
    </fixed>
    """
    xml = ARM.format(tendons=tns, actuators="")
    mo, do, m, d = _pair(xml)
    step = jax.jit(engine.step)
    for q in (0.2, 0.05, 0.5):     # inside, below, above the deadband
        do.qpos[:] = [q, 0, 0]
        mujoco.mj_forward(mo, do)
        dd = d.replace(qpos=jnp.asarray([q, 0, 0], d.qpos.dtype))
        dd = engine.forward(m, dd)
        np.testing.assert_allclose(np.asarray(dd.qfrc_spring),
                                   do.qfrc_spring, atol=1e-12)


SPATIAL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="anchor" pos="0 0 1.5"/>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
      <site name="mid" pos="0.15 0 0.03"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="1 0 0" damping="0.05"/>
        <geom type="capsule" size="0.015" fromto="0 0 0 0 0.2 0"
              mass="0.3"/>
        <site name="tip" pos="0 0.2 0"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="60" damping="2" springlength="0.4"
             limited="true" range="0 0.9">
      <site site="anchor"/><site site="mid"/><site site="tip"/>
    </spatial>
  </tendon>
  <actuator><general name="wind" tendon="cable" gainprm="5"/></actuator>
</mujoco>
"""


def test_spatial_tendon_oracle():
    """straight site-chain tendon: length/J/velocity, spring+damper,
    limit rows, tendon actuator — machine-precision vs the oracle."""
    mo, do, m, d = _pair(SPATIAL)
    np.testing.assert_allclose(np.asarray(m.ten_invweight0),
                               mo.tendon_invweight0, rtol=1e-9)
    qs, vs, cs = [0.5, -0.3], [0.4, -0.6], [-0.5]
    do.qpos[:] = qs
    do.qvel[:] = vs
    do.ctrl[:] = cs
    mujoco.mj_forward(mo, do)
    d = d.replace(qpos=jnp.asarray(qs, d.qpos.dtype),
                  qvel=jnp.asarray(vs, d.qpos.dtype),
                  ctrl=jnp.asarray(cs, d.qpos.dtype))
    d = engine.forward(m, d)
    np.testing.assert_allclose(np.asarray(d.ten_length), do.ten_length,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.ten_J).ravel(),
                               do.ten_J.ravel(), atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.qfrc_spring), do.qfrc_spring,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.qacc), do.qacc, atol=1e-9)
    step = jax.jit(engine.step)
    for _ in range(300):
        mujoco.mj_step(mo, do)
        d = step(m, d)
    assert np.abs(do.qpos - np.asarray(d.qpos)).max() < 1e-10


def _forward_pair(mo, do, m, d, qpos, qvel, ctrl=None):
    do.qpos[:] = qpos
    do.qvel[:] = qvel
    if ctrl is not None:
        do.ctrl[:] = ctrl
    mujoco.mj_forward(mo, do)
    d = d.replace(qpos=jnp.asarray(qpos, d.qpos.dtype),
                  qvel=jnp.asarray(qvel, d.qpos.dtype))
    if ctrl is not None:
        d = d.replace(ctrl=jnp.asarray(ctrl, d.qpos.dtype))
    return do, engine.forward(m, d)


WRAP_CYL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a" pos="-0.5 0.25 0.1"/>
    <geom name="cyl" type="cylinder" size="0.1 0.8" euler="0.2 -0.15 0"/>
    <site name="side_lo" pos="0.3 0 -0.3"/>
    <body pos="0.5 -0.25 0.4">
      <joint name="jx" type="slide" axis="1 0 0" damping="0.4"/>
      <joint name="jz" type="slide" axis="0 0 1" damping="0.4"/>
      <geom type="sphere" size="0.03" mass="1"/>
      <site name="b"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="25" damping="1.5" springlength="0.9">
      <site site="a"/><geom geom="cyl"/><site site="b"/>
    </spatial>
  </tendon>
</mujoco>
"""


def test_cylinder_wrap_oracle():
    """tilted cylinder wrap: length, full moment row, passive forces and
    qacc match mju_wrap to machine precision; wrap engages/disengages
    along a 400-step rollout without divergence."""
    mo, do, m, d = _pair(WRAP_CYL)
    for qpos, qvel in [([0.0, 0.0], [0.1, -0.2]),       # wrapped
                       ([0.2, 0.6], [0.0, 0.3]),        # straight (above)
                       ([-0.1, -0.25], [0.5, 0.1])]:    # deep wrap
        do_, d_ = _forward_pair(mo, do, m, d, np.array(qpos),
                                np.array(qvel))
        np.testing.assert_allclose(np.asarray(d_.ten_length),
                                   do_.ten_length, atol=1e-10,
                                   err_msg=str(qpos))
        np.testing.assert_allclose(np.asarray(d_.ten_J).ravel(),
                                   do_.ten_J.ravel(), atol=1e-9,
                                   err_msg=str(qpos))
        np.testing.assert_allclose(np.asarray(d_.qacc), do_.qacc,
                                   atol=1e-7, err_msg=str(qpos))
    step = jax.jit(engine.step)
    do.qpos[:] = [0.0, 0.0]
    do.qvel[:] = [0.4, 0.8]
    d = d.replace(qpos=jnp.asarray([0.0, 0.0], d.qpos.dtype),
                  qvel=jnp.asarray([0.4, 0.8], d.qpos.dtype))
    for _ in range(400):
        mujoco.mj_step(mo, do)
        d = step(m, d)
    assert np.abs(do.qpos - np.asarray(d.qpos)).max() < 1e-8


WRAP_SPH = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a" pos="-0.5 0.1 0.3"/>
    <geom name="ball" type="sphere" size="0.12" pos="0 0 0.05"/>
    <site name="below" pos="0 0 -0.4"/>
    <body pos="0.5 -0.1 0.3">
      <joint name="jz" type="slide" axis="0 0 1" damping="0.3"/>
      <geom type="sphere" size="0.03" mass="0.5"/>
      <site name="b"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="40" damping="2" springlength="0.7">
      <site site="a"/><geom geom="ball" sidesite="below"/><site site="b"/>
    </spatial>
  </tendon>
  <actuator><general name="pull" tendon="cable" gainprm="8"/></actuator>
</mujoco>
"""


def test_sphere_wrap_sidesite_oracle():
    """sidesite on the far side FORCES the wrap even when the straight
    segment misses the sphere (probed mju_wrap rule); actuator moment
    through the wrapped row matches."""
    mo, do, m, d = _pair(WRAP_SPH)
    for qpos, qvel, ctrl in [([0.0], [0.2], [-0.5]),    # forced wrap
                             ([-0.45], [0.1], [0.3]),   # segment crosses
                             ([0.0], [-0.3], [0.0])]:
        do_, d_ = _forward_pair(mo, do, m, d, np.array(qpos),
                                np.array(qvel), np.array(ctrl))
        np.testing.assert_allclose(np.asarray(d_.ten_length),
                                   do_.ten_length, atol=1e-10,
                                   err_msg=str(qpos))
        np.testing.assert_allclose(np.asarray(d_.ten_J).ravel(),
                                   do_.ten_J.ravel(), atol=1e-9)
        np.testing.assert_allclose(np.asarray(d_.qacc), do_.qacc,
                                   atol=1e-7)
    step = jax.jit(engine.step)
    do.qvel[:] = [0.5]
    do.ctrl[:] = [-0.4]
    d = d.replace(qvel=jnp.asarray([0.5], d.qpos.dtype),
                  ctrl=jnp.asarray([-0.4], d.qpos.dtype))
    for _ in range(300):
        mujoco.mj_step(mo, do)
        d = step(m, d)
    assert np.abs(do.qpos - np.asarray(d.qpos)).max() < 1e-8


def test_wrap_inside_oracle():
    """sidesite INSIDE the geom: tendon must touch the surface (single
    minimizing point) unless the segment already crosses."""
    xml = """
    <mujoco>
      <compiler angle="radian"/>
      <option timestep="0.002"/>
      <worldbody>
        <site name="a" pos="-0.5 0 0.3"/>
        <geom name="cyl" type="cylinder" size="0.1 0.5"
              euler="1.5707963 0 0"/>
        <site name="inside" pos="0.02 0 0.03"/>
        <body pos="0.5 0 0.2">
          <joint name="jz" type="slide" axis="0 0 1" damping="0.2"/>
          <geom type="sphere" size="0.03" mass="0.5"/>
          <site name="b"/>
        </body>
      </worldbody>
      <tendon>
        <spatial name="cable" stiffness="30" damping="1" springlength="0.8">
          <site site="a"/><geom geom="cyl" sidesite="inside"/>
          <site site="b"/>
        </spatial>
      </tendon>
    </mujoco>
    """
    mo, do, m, d = _pair(xml)
    for qpos, qvel in [([0.1], [0.2]),     # touch (asymmetric heights)
                       ([0.35], [0.0]),    # touch, higher
                       ([-0.45], [0.1])]:  # segment crosses -> straight
        do_, d_ = _forward_pair(mo, do, m, d, np.array(qpos),
                                np.array(qvel))
        np.testing.assert_allclose(np.asarray(d_.ten_length),
                                   do_.ten_length, atol=1e-8,
                                   err_msg=str(qpos))
        np.testing.assert_allclose(np.asarray(d_.ten_J).ravel(),
                                   do_.ten_J.ravel(), atol=1e-6)


def test_pulley_oracle():
    """pulley divisor scales branch lengths/moments and breaks the chain
    (no segment across the pulley)."""
    xml = """
    <mujoco>
      <compiler angle="radian"/>
      <option timestep="0.002"/>
      <worldbody>
        <site name="a" pos="0 0 1"/>
        <body pos="0 0 0.5">
          <joint name="j1" type="slide" axis="0 0 1" damping="0.1"/>
          <geom type="sphere" size="0.03" mass="1"/>
          <site name="b"/>
        </body>
        <site name="c" pos="0.3 0 1"/>
        <body pos="0.3 0 0.4">
          <joint name="j2" type="slide" axis="0 0 1" damping="0.1"/>
          <geom type="sphere" size="0.03" mass="0.7"/>
          <site name="e"/>
        </body>
      </worldbody>
      <tendon>
        <spatial name="t" stiffness="50" springlength="0.7"
                 limited="true" range="0 0.85">
          <site site="a"/><site site="b"/>
          <pulley divisor="2"/>
          <site site="c"/><site site="e"/>
        </spatial>
      </tendon>
      <actuator><general name="winch" tendon="t" gainprm="10"/></actuator>
    </mujoco>
    """
    mo, do, m, d = _pair(xml)
    np.testing.assert_allclose(np.asarray(m.ten_invweight0),
                               mo.tendon_invweight0, rtol=1e-9)
    do_, d_ = _forward_pair(mo, do, m, d, np.array([0.1, -0.2]),
                            np.array([0.3, 0.4]), np.array([-0.6]))
    np.testing.assert_allclose(np.asarray(d_.ten_length), do_.ten_length,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d_.ten_J).ravel(),
                               do_.ten_J.ravel(), atol=1e-12)
    np.testing.assert_allclose(np.asarray(d_.qacc), do_.qacc, atol=1e-9)
    step = jax.jit(engine.step)
    do.ctrl[:] = [-0.6]
    d = d_.replace(qpos=jnp.zeros(2, d.qpos.dtype),
                   qvel=jnp.zeros(2, d.qpos.dtype))
    do.qpos[:] = 0
    do.qvel[:] = 0
    for _ in range(300):
        mujoco.mj_step(mo, do)
        d = step(m, d)
    assert np.abs(do.qpos - np.asarray(d.qpos)).max() < 1e-10


def test_tendon_equality_oracle():
    """<equality><tendon>: couples two tendon lengths through the moment
    rows, (L1-L1_0) = poly(L2-L2_0) — efc rows and qacc match."""
    xml = """
    <mujoco>
      <compiler angle="radian"/>
      <option timestep="0.002"/>
      <worldbody>
        <body pos="0 0 1">
          <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
          <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="1"/>
          <body pos="0.3 0 0">
            <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
            <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0"
                  mass="0.4"/>
            <body pos="0.25 0 0">
              <joint name="j3" type="slide" axis="1 0 0" damping="0.2"/>
              <geom type="sphere" size="0.03" mass="0.2"/>
            </body>
          </body>
        </body>
      </worldbody>
      <tendon>
        <fixed name="ta"><joint joint="j1" coef="0.5"/>
          <joint joint="j2" coef="-0.3"/></fixed>
        <fixed name="tb"><joint joint="j2" coef="1.1"/>
          <joint joint="j3" coef="0.8"/></fixed>
      </tendon>
      <equality>
        <tendon tendon1="ta" tendon2="tb" polycoef="0.02 0.7 0.3 0 0"/>
      </equality>
    </mujoco>
    """
    mo, do, m, d = _pair(xml)
    do_, d_ = _forward_pair(mo, do, m, d, np.array([0.3, -0.2, 0.1]),
                            np.array([0.5, -0.4, 0.2]))
    assert do_.ne == 1
    i = np.nonzero(np.asarray(d_.efc_active))[0]
    np.testing.assert_allclose(np.asarray(d_.efc_J)[i[0]],
                               np.asarray(do_.efc_J).ravel()[:mo.nv],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d_.qacc), do_.qacc, atol=1e-9)
    step = jax.jit(engine.step)
    do.qpos[:] = 0
    do.qvel[:] = [0.5, -0.4, 0.2]
    d = d.replace(qpos=jnp.zeros(3, d.qpos.dtype),
                  qvel=jnp.asarray([0.5, -0.4, 0.2], d.qpos.dtype))
    for _ in range(300):
        mujoco.mj_step(mo, do)
        d = step(m, d)
    assert np.abs(do.qpos - np.asarray(d.qpos)).max() < 1e-10


def test_unknown_equality_raises():
    xml = """
    <mujoco><worldbody>
      <body name="b1"><joint type="hinge"/>
        <geom type="sphere" size="0.1" mass="1"/></body>
    </worldbody>
    <equality><distance body1="b1" body2="world"/></equality></mujoco>
    """
    with pytest.raises(ValueError, match="not supported"):
        parse_mjcf_string(xml)


def test_unknown_wrap_element_raises():
    xml = """
    <mujoco><worldbody>
      <site name="s1"/>
      <body><joint type="hinge"/><geom type="sphere" size="0.1" mass="1"/>
        <site name="s2"/></body>
    </worldbody>
    <tendon><spatial name="sp"><site site="s1"/>
      <unknown thing="1"/><site site="s2"/></spatial>
    </tendon></mujoco>
    """
    with pytest.raises(ValueError, match="not supported"):
        parse_mjcf_string(xml)


def test_box_wrap_geom_raises():
    xml = """
    <mujoco><worldbody>
      <site name="s1"/>
      <geom name="wrap" type="box" size="0.05 0.05 0.2"/>
      <body><joint type="hinge"/><geom type="sphere" size="0.1" mass="1"/>
        <site name="s2"/></body>
    </worldbody>
    <tendon><spatial name="sp"><site site="s1"/><geom geom="wrap"/>
      <site site="s2"/></spatial>
    </tendon></mujoco>
    """
    with pytest.raises(ValueError, match="sphere or cylinder"):
        compile_spec(parse_mjcf_string(xml))


def test_tendon_names_and_export_roundtrip(tmp_path):
    from mujoco_sim_tpu.models.export_mjcf import export_mjcf
    xml = ARM.format(tendons=TENDONS,
                     actuators='<general name="at" tendon="t1" gear="1.7" '
                               'gainprm="3.0"/>')
    spec = parse_mjcf_string(xml)
    m = compile_spec(spec)
    assert m.ntendon == 2
    assert m.names.tendon == ("t1", "t2")
    assert m.names.tendon_id("t2") == 1
    out = str(tmp_path / "roundtrip.xml")
    export_mjcf(spec, out)
    spec2 = parse_mjcf_string(open(out).read())
    m2 = compile_spec(spec2)
    np.testing.assert_allclose(np.asarray(m2.layout.ten_Wq),
                               np.asarray(m.layout.ten_Wq), atol=1e-12)
    np.testing.assert_allclose(np.asarray(m2.ten_springlength),
                               np.asarray(m.ten_springlength), atol=1e-12)
    assert m2.nu == 1 and int(m2.layout.act_trntype[0]) == 3
