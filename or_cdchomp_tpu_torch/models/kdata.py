# Copied from or_cdchomp_tpu/models/kdata.py (host numpy; shared copy pending de-duplication).
"""Sphere collision-model XML parsing (the orcdchomp kdata plugin).

The reference attaches sphere models to robots via a custom kinbody XML
tag parsed by orcdchomp_kdata.cpp:65-98::

    <orcdchomp>
      <spheres>
        <sphere link="wam2" pos="0.0 0.0 0.2" radius="0.06"/>
        ...
      </spheres>
    </orcdchomp>

(fixture: scripts/barrettwam_withspheres.robot.xml:22-46).  This module
reads that exact format — either a whole robot XML file containing an
``<orcdchomp>`` element, or a bare fragment — and returns sphere rows
``(link_name, (x, y, z), radius)`` suitable for RobotModel.from_joints
/ with_spheres.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import List, Tuple

import numpy as np


def _find_orcdchomp(root: ET.Element):
    if root.tag.lower() == "orcdchomp":
        return root
    # search anywhere in the tree (the tag lives inside <KinBody>)
    for el in root.iter():
        if el.tag.lower() == "orcdchomp":
            return el
    return None


def parse_spheres_xml(text: str) -> List[Tuple[str, tuple, float]]:
    """Parse sphere rows from an XML string.

    Raises ValueError when no <orcdchomp><spheres> model is present,
    mirroring the reference's "no spheres! kinbody does not have a
    <orcdchomp> tag defined?" error (orcdchomp_mod.cpp:2262).
    """
    root = ET.fromstring(text)
    kd = _find_orcdchomp(root)
    if kd is None:
        raise ValueError(
            "no spheres! kinbody does not have a <orcdchomp> tag defined?")
    out = []
    for spheres in kd:
        if spheres.tag.lower() != "spheres":
            continue
        for s in spheres:
            if s.tag.lower() != "sphere":
                continue
            link = s.attrib["link"]
            pos = tuple(float(v) for v in s.attrib["pos"].split())
            if len(pos) != 3:
                raise ValueError(f"sphere pos must have 3 values: {s.attrib}")
            radius = float(s.attrib["radius"])
            out.append((link, pos, radius))
    if not out:
        raise ValueError(
            "no spheres! kinbody does not have a <orcdchomp> tag defined?")
    return out


def load_spheres_file(path: str) -> List[Tuple[str, tuple, float]]:
    with open(path) as f:
        return parse_spheres_xml(f.read())


def with_spheres(model, spheres):
    """Return a copy of a RobotModel with its sphere set replaced by
    parsed rows (link must exist in the model)."""
    link_idx = {n: i for i, n in enumerate(model.link_names)}
    for link, _, _ in spheres:
        if link not in link_idx:
            raise ValueError(
                f"link {link} in <orcdchomp> does not exist.")
    sl = np.array([link_idx[s[0]] for s in spheres], dtype=np.int64)
    sp = np.array([s[1] for s in spheres], dtype=np.float64).reshape(-1, 3)
    sr = np.array([s[2] for s in spheres], dtype=np.float64)
    return dataclasses.replace(model, sphere_link=sl, sphere_pos=sp,
                               sphere_radius=sr)
