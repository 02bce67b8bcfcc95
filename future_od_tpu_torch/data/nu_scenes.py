"""nuScenes taxonomy (the start of a port of future_od_tpu/data/nu_scenes.py).
The dataset itself comes later (ROADMAP.md Queue 1 item 2a)."""
from __future__ import annotations

CATEGORY_DICT = {
    0: "Vehicle",
    1: "Truck",
    2: "Trailer",
    3: "Pedestrian",
    4: "Bus",
    5: "Motorcyclist",
    6: "Bicyclist",
    7: "ConstructionVehicle",
}
