"""The port's robot loaders (models/kdata.py, orxml.py, urdf.py) against
the JAX package's, on the inline XML and URDF of tests/test_orxml.py,
test_urdf.py and test_transport.py: every RobotModel field equal, the
sphere centres through each package's FK equal at 1e-12 (float64, CPU),
the same error messages; an end-to-end solve of an XML robot through
both modules; and chip_smoke's WAM7 XML against the built-in wam7()."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.models import kdata as jkdata
from or_cdchomp_tpu.models import orxml as jorxml
from or_cdchomp_tpu.models import urdf as jurdf
from or_cdchomp_tpu.models.robot import CompiledFK as JaxFK

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.models import kdata, urdf
from or_cdchomp_tpu_torch.models.robot import CompiledFK

from test_orxml import MINI
from test_urdf import URDF_2R
from torch_parity import close, share_fields

RTOL = 1e-12

FINGER = MINI.replace("<orcdchomp>", """<Body name="finger">
     <offsetfrom>link2</offsetfrom>
     <Translation>0.05 0.05 0</Translation>
   </Body>
   <Joint name="jf" type="hinge">
     <Body>link2</Body><Body>finger</Body>
     <offsetfrom>finger</offsetfrom>
     <axis>0 0 1</axis>
     <limitsdeg>0 90</limitsdeg>
   </Joint>
   <orcdchomp>""")
# OpenRAVE's other transform and joint forms: <rotationmat>, a slider,
# <limitsrad>, <maxveldeg>, an anchored hinge as the effector's joint
FORMS = """<Robot name="forms"><KinBody>
  <Body name="base"/>
  <Body name="a">
    <offsetfrom>base</offsetfrom>
    <Translation>0.1 0 0.2</Translation>
    <rotationmat>0 -1 0 1 0 0 0 0 1</rotationmat>
  </Body>
  <Body name="b">
    <offsetfrom>a</offsetfrom>
    <Translation>0 0.3 0</Translation>
    <RotationAxis>1 0 0 30</RotationAxis>
  </Body>
  <Joint name="ja" type="slider">
    <Body>base</Body><Body>a</Body><offsetfrom>a</offsetfrom>
    <axis>0 0 1</axis><limits>-0.2 0.3</limits><maxvel>0.5</maxvel>
  </Joint>
  <Joint name="jb" type="hinge">
    <Body>a</Body><Body>b</Body><offsetfrom>b</offsetfrom>
    <axis>0 1 1</axis><anchor>0.02 0 -0.04</anchor>
    <limitsrad>-1.5 1.2</limitsrad><maxveldeg>90</maxveldeg>
  </Joint>
  <orcdchomp><spheres>
    <sphere link="a" pos="0 0 0.05" radius="0.05"/>
    <sphere link="b" pos="0.01 0.1 0" radius="0.04"/>
  </spheres></orcdchomp>
</KinBody>
<Manipulator name="m"><effector>b</effector></Manipulator>
</Robot>"""
INNER = """<KinBody name="inner">
  <Body name="base"/>
  <Body name="l1">
    <offsetfrom>base</offsetfrom><Translation>0 0 0.5</Translation>
  </Body>
  <Joint name="j1" type="hinge">
    <Body>base</Body><Body>l1</Body>
    <offsetfrom>l1</offsetfrom><axis>0 0 1</axis>
    <limitsdeg>-90 90</limitsdeg>
  </Joint>
  <orcdchomp><spheres>
    <sphere link="l1" pos="0 0 0.1" radius="0.07"/>
  </spheres></orcdchomp>
</KinBody>"""
OUTER = """<Robot name="r"><KinBody>
  <KinBody file="inner.xml"/>
</KinBody></Robot>"""
URDF_FIXED = URDF_2R.replace("</robot>", """
  <link name="tool">
    <collision><origin xyz="0.1 0 0" rpy="0.3 -0.2 0.1"/>
      <geometry><sphere radius="0.02"/></geometry></collision>
  </link>
  <joint name="wrist" type="fixed">
    <parent link="fore"/><child link="tool"/>
    <origin xyz="0 0 0.45" rpy="0.5 0.4 -0.3"/>
  </joint>
  <joint name="slide" type="prismatic">
    <parent link="base"/><child link="rail"/>
    <axis xyz="1 0 0"/><limit lower="-0.1" upper="0.1" velocity="0.2"/>
  </joint>
  <link name="rail"/>
</robot>""")


def assert_models_equal(tm, jm):
    """Every field of the port's RobotModel equal to the JAX one's."""
    assert [f.name for f in dataclasses.fields(tm)] == \
        [f.name for f in dataclasses.fields(jm)]
    for f in dataclasses.fields(jm):
        got, want = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, f.name
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                       err_msg=f.name)
        elif want is None:
            assert got is None, f.name
        else:
            assert got == want, f.name


def assert_fk_equal(tm, jm, n=5, seed=0):
    """Sphere centres of both packages' FK at n seeded configurations
    within the limits (±1.2 where unbounded), float64."""
    if tm.n_dof == 0 or len(tm.sphere_radius) == 0:
        return
    rng = np.random.default_rng(seed)
    lo = np.maximum(jm.dof_limits_lower, -1.2)
    hi = np.minimum(jm.dof_limits_upper, 1.2)
    q = rng.uniform(lo, hi, size=(n, jm.n_dof))
    base = np.array([0.1, -0.2, 0.3, 0.0, 0.0, np.sin(0.2), np.cos(0.2)])
    jfk = JaxFK(jm, dtype=jnp.float64)
    want = np.stack([np.asarray(jfk.sphere_positions_jit(
        jnp.asarray(qi), jnp.asarray(base))) for qi in q])      # (n, S, 3)
    fk = CompiledFK(tm, dtype=torch.float64, device="cpu")
    qT = torch.as_tensor(q.T[None])                             # (1, D, n)
    b = torch.as_tensor(np.tile(base, (n, 1)))
    x = fk.fk_soa(qT, tuple(b[:, i] for i in range(3)),
                  tuple(b[:, i] for i in range(3, 7))).x
    close(x[:, 0].permute(2, 1, 0), want, RTOL)


def _both(fn_t, fn_j, *args, **kw):
    """Each package's result, or the same exception from both."""
    try:
        want = fn_j(*args, **kw)
    except (ValueError, FileNotFoundError, KeyError) as e:
        with pytest.raises(type(e)) as got:
            fn_t(*args, **kw)
        assert str(got.value) == str(e)
        return None, None
    return fn_t(*args, **kw), want


XML_CASES = {
    "mini": (MINI, {}),
    "mini_active_j2": (MINI, dict(active=["j2"])),
    "finger_default_chain": (FINGER, {}),
    "finger_all_active": (FINGER, dict(active=["j1", "j2", "jf"])),
    "forms": (FORMS, {}),
    "named": (MINI, dict(name="renamed")),
    "malformed_spheres": (MINI.replace('pos="0 0 0.1"', 'pos="0 0"'), {}),
    "unknown_sphere_link": (MINI.replace('link="tool"', 'link="nope"'), {}),
    "external_include": (OUTER.replace("inner.xml",
                                       "robots/wam7.kinbody.xml"), {}),
    "not_a_robot": ("<Environment/>", {}),
    "no_bodies": ("<Robot><KinBody/></Robot>", {}),
}


@pytest.mark.parametrize("case", sorted(XML_CASES))
def test_parse_robot_xml_matches_jax(case):
    text, kw = XML_CASES[case]
    tm, jm = _both(pt.parse_robot_xml, jorxml.parse_robot_xml, text, **kw)
    if jm is None:
        return
    assert_models_equal(tm, jm)
    assert_fk_equal(tm, jm)


@pytest.mark.parametrize("with_spheres", [True, False])
def test_included_file_matches_jax(tmp_path, with_spheres):
    """<KinBody file=…> resolved through search_paths and through a path
    to the outer file; its spheres are collected."""
    inner = INNER if with_spheres else INNER.replace(
        INNER[INNER.index("<orcdchomp>"):INNER.index("</KinBody>")], "")
    (tmp_path / "inner.xml").write_text(inner)
    (tmp_path / "outer.xml").write_text(OUTER)
    for args, kw in (((OUTER,), dict(search_paths=[str(tmp_path)])),
                     ((str(tmp_path / "outer.xml"),), {})):
        tm, jm = _both(pt.parse_robot_xml, jorxml.parse_robot_xml, *args,
                       **kw)
        assert_models_equal(tm, jm)
        assert len(tm.sphere_radius) == int(with_spheres)


URDF_CASES = {
    "2r": (URDF_2R, {}),
    "2r_no_spheres": (URDF_2R, dict(use_collision_spheres=False)),
    "2r_ee_upper": (URDF_2R, dict(ee_link="upper")),
    "fixed_and_prismatic": (URDF_FIXED, {}),
    "no_links": ("<robot name='x'></robot>", {}),
    "planar_joint": ("""<robot name="x"><link name="a"/><link name="b"/>
      <joint name="j" type="planar">
        <parent link="a"/><child link="b"/></joint></robot>""", {}),
    "two_roots": ("""<robot name="x"><link name="a"/><link name="b"/>
      <link name="c"/>
      <joint name="j" type="fixed">
        <parent link="a"/><child link="b"/></joint></robot>""", {}),
    "unknown_link": ("""<robot name="x"><link name="a"/>
      <joint name="j" type="fixed">
        <parent link="a"/><child link="z"/></joint></robot>""", {}),
    "not_urdf": ("<Robot name='x'/>", {}),
    "bad_origin": (URDF_2R.replace('xyz="0 0 0.1"', 'xyz="0 0"'), {}),
}


@pytest.mark.parametrize("case", sorted(URDF_CASES))
def test_parse_urdf_matches_jax(case):
    text, kw = URDF_CASES[case]
    tm, jm = _both(pt.parse_urdf, jurdf.parse_urdf, text, **kw)
    if jm is None:
        return
    assert_models_equal(tm, jm)
    assert_fk_equal(tm, jm)


def test_load_urdf_from_file(tmp_path):
    path = tmp_path / "rr.urdf"
    path.write_text(URDF_2R)
    assert_models_equal(pt.load_urdf(str(path), ee_link="fore"),
                        jurdf.load_urdf(str(path), ee_link="fore"))


@pytest.mark.parametrize("rpy", [(0.6, 0, 0), (0, 0, 0.6), (0.3, -0.5, 0.9),
                                 (np.pi, 0.2, -2.0)])
def test_quat_from_rpy_matches_jax(rpy):
    close(urdf._quat_from_rpy(np.array(rpy)),
          jurdf._quat_from_rpy(np.array(rpy)), RTOL)


SPHERES_XML = """
<Robot name="BarrettWAM"><KinBody>
  <orcdchomp><spheres>
    <sphere link="wam0" pos=" 0.22  0.14 0.346" radius="0.15" />
    <sphere link="wam2" pos=" 0.0   0.0  0.2 " radius="0.06" />
  </spheres></orcdchomp>
</KinBody></Robot>"""


@pytest.mark.parametrize("text", [
    SPHERES_XML, "<Robot><KinBody/></Robot>",
    "<orcdchomp><spheres/></orcdchomp>",
    SPHERES_XML.replace('pos=" 0.0   0.0  0.2 "', 'pos="1 2"')])
def test_parse_spheres_xml_matches_jax(text):
    got, want = _both(kdata.parse_spheres_xml, jkdata.parse_spheres_xml,
                      text)
    assert got == want


@pytest.mark.parametrize("rows", [
    [("wam2", (0, 0, 0.25), 0.07)],
    [("wam0", (0.22, 0.14, 0.346), 0.15), ("Finger0-2", (0.05, 0, 0), 0.04)],
    [("nolink", (0, 0, 0), 0.1)]])
def test_with_spheres_matches_jax(rows):
    got, want = _both(kdata.with_spheres, jkdata.with_spheres, pt.wam7(),
                      rows)
    if want is not None:
        assert want.sphere_radius.shape == (len(rows),)
        # the JAX function applied to the JAX wam7: the port's wam7 is a
        # copy, so every field agrees
        assert_models_equal(got, jkdata.with_spheres(oc.wam7(), rows))


def test_end_to_end_solve_from_xml():
    """An XML robot through both modules (tests/test_orxml.py's solve):
    create, 30 iterations and gettraj, trajectories equal at 1e-9."""
    outs = []
    mods = []
    for pkg, kw in ((pt, dict(dtype=torch.float64, device="cpu")),
                    (oc, dict(dtype=jnp.float64))):
        mod = pkg.CHOMPModule(**kw)
        mod.add_kinbody(pkg.KinBody("ball", pkg.Scene.build(
            spheres=[((0.3, 0.0, 0.45), 0.08)])))
        r = pkg.Robot("mini", pkg.parse_robot_xml(MINI),
                      q_active=np.array([0.3, 0.4]))
        mod.add_robot(r)
        r.enabled = False
        mod.computedistancefield(kinbody="ball", cube_extent=0.06)
        r.enabled = True
        mods.append(mod)
    share_fields(*mods)
    for mod in mods:
        outs.append(mod.runchomp(
            robot="mini", n_iter=30, lambda_=100.0, obs_factor=200.0,
            n_points=11, adofgoal=[-0.5, -0.3],
            no_collision_exception=True))
    assert outs[0].positions.shape == (11, 2)
    close(outs[0].positions, outs[1].positions, 1e-9)
    close(outs[0].times, outs[1].times, 1e-9)
    assert outs[0].in_collision == outs[1].in_collision


def test_chip_smoke_wam7_xml_matches_builtin():
    """chip_smoke's front door robot: the built-in WAM7 + hand written as
    OpenRAVE XML and read back by both packages' parsers; its sphere
    centres equal wam7()'s at 64 configurations (float64, 1e-12)."""
    import chip_smoke

    text = chip_smoke.wam7_xml(pt)
    tm, jm = _both(pt.parse_robot_xml, jorxml.parse_robot_xml, text)
    assert_models_equal(tm, jm)
    assert tm.dof_names == pt.wam7().dof_names
    err = chip_smoke.xml_sphere_error(torch, pt, tm, "cpu", torch.float64)
    assert err <= chip_smoke.XML_BAR["cpu"], err
