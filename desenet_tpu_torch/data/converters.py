"""Dataset label converters, the port's copy of
``desenet_tpu/data/converters.py`` (the same label files, byte for byte):

- voc_xml_to_txt: Pascal-VOC xml -> normalized "cls x y w h" det labels;
- labelme_json_to_txt: labelme json polygons -> normalized "cls x1 y1 ..."
  seg labels.
"""

from __future__ import annotations

import itertools
import json
import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np


def voc_xml_to_txt(src_dir: str, out_dir: str, class_map: Dict[str, int]):
    """Convert every .xml in src_dir to a YOLO det .txt in out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fp in sorted(os.listdir(src_dir)):
        if not fp.endswith(".xml"):
            continue
        root = ET.parse(os.path.join(src_dir, fp)).getroot()
        size = root.find("size")
        width = float(size.find("width").text)
        height = float(size.find("height").text)
        lines = []
        for obj in root.findall("object"):
            label = obj.find("name").text
            if label not in class_map:
                continue
            bb = obj.find("bndbox")
            xmin = float(bb.find("xmin").text)
            ymin = float(bb.find("ymin").text)
            xmax = float(bb.find("xmax").text)
            ymax = float(bb.find("ymax").text)
            if width <= 0 or height <= 0:
                continue
            cx = (xmin + xmax) / (2 * width)
            cy = (ymin + ymax) / (2 * height)
            w = (xmax - xmin) / width
            h = (ymax - ymin) / height
            lines.append(
                f"{class_map[label]} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}"
            )
        if lines:
            out = os.path.join(out_dir, fp[:-4] + ".txt")
            with open(out, "w") as f:
                f.write("\n".join(lines) + "\n")
            n += 1
    return n


def labelme_json_to_txt(src_dir: str, out_dir: str, class_map: Dict[str, int]):
    """Convert every labelme .json in src_dir to a seg-polygon .txt."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fp in sorted(os.listdir(src_dir)):
        if not fp.endswith(".json"):
            continue
        with open(os.path.join(src_dir, fp)) as f:
            data = json.load(f)
        wh = np.array([data["imageWidth"], data["imageHeight"]], np.float64)
        lines = []
        for shape in data.get("shapes", []):
            label = shape.get("label")
            if label not in class_map or not shape.get("points"):
                continue
            pts = np.clip(np.asarray(shape["points"], np.float64) / wh, 0, 1)
            flat = " ".join(map(str, itertools.chain(*pts)))
            lines.append(f"{class_map[label]} {flat}")
        if lines:
            with open(os.path.join(out_dir, fp[:-5] + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            n += 1
    return n
