"""Parts of chip_smoke.py that need no card: the refusal to run on the CPU
and the per-class qpos comparison of its reference phase."""

from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.device_phase()


def _quat_z(angle):
    return np.array([np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)])


def test_qpos_gaps_split_joints_positions_rotations():
    # one hinge (qpos 0) and one free body (qpos 1:4 position, 4:8 quat)
    m = SimpleNamespace(jnt_type=np.array([3, 0]),
                        jnt_qposadr=np.array([0, 1]))
    qa = np.zeros((2, 8))
    qa[:, 4:] = _quat_z(0.3)
    qb = qa.copy()
    qb[0, 0] += 1e-3                 # hinge angle
    qb[1, 2] -= 2e-3                 # body position
    qb[1, 4:] = _quat_z(0.3 + 0.01)  # body rotated 0.01 rad about z
    gaps = chip_smoke.qpos_gaps(m, qa, qb)
    assert gaps["joint"] == pytest.approx(1e-3)
    assert gaps["pos"] == pytest.approx(2e-3)
    assert gaps["rot"] == pytest.approx(0.01, rel=1e-6)


def test_qpos_gaps_ignore_quaternion_sign_and_norm():
    m = SimpleNamespace(jnt_type=np.array([0]), jnt_qposadr=np.array([0]))
    qa = np.zeros((1, 7))
    qa[0, 3:] = _quat_z(1.0)
    qb = qa.copy()
    qb[0, 3:] *= -1.001              # the same orientation
    gaps = chip_smoke.qpos_gaps(m, qa, qb)
    assert gaps == {"joint": 0.0, "pos": 0.0, "rot": pytest.approx(0.0)}
