"""UT CODa label taxonomies (public-dataset metadata).

Facts of the dataset annotation scheme (reference: creste/datasets/
coda_utils.py:33-453): the 25-class terrain-semantic taxonomy with its
18-class training remap, and the 60-class object taxonomy with its 32-class
remap. Stored as name->(raw_id, remap_id) tables; flat remap arrays are
derived for the one-hot channel folding the SSC/SOC label loaders use.

A copy of ``creste_public_tpu/data/taxonomy.py``.
"""
from __future__ import annotations

import numpy as np

# terrain semantics: name -> (raw id, remapped id)
SEM_CLASSES = {
    'unlabeled': (0, 0),  # -> unlabeled
    'concrete': (1, 1),  # -> concrete
    'grass': (2, 2),  # -> grass
    'rocks': (3, 3),  # -> rocks
    'speedway bricks': (4, 4),  # -> speedway bricks
    'red bricks': (5, 5),  # -> red bricks
    'pebble pavement': (6, 6),  # -> pebble pavement
    'light marbiling tiling': (7, 7),  # -> tiling
    'dark marble tiling': (8, 7),  # -> tiling
    'dirt paths': (9, 8),  # -> dirt paths
    'road pavement': (10, 9),  # -> road pavement
    'short vegetation': (11, 10),  # -> short vegetation
    'porcelain tile': (12, 7),  # -> tiling
    'metal grates': (13, 11),  # -> metal grates
    'blond marble tiling': (14, 7),  # -> tiling
    'wood panels': (15, 12),  # -> wood panels
    'patterned tile': (16, 7),  # -> tiling
    'carpet': (17, 13),  # -> carpet
    'crosswalk': (18, 14),  # -> crosswalk
    'dome mat': (19, 15),  # -> mat
    'stairs': (20, 16),  # -> stairs
    'door mat': (21, 15),  # -> mat
    'threshold': (22, 17),  # -> other
    'metal floor': (23, 17),  # -> other
    'other': (24, 17),  # -> other
}

SEM_REMAP_NAMES = ['unlabeled', 'concrete', 'grass', 'rocks', 'speedway bricks', 'red bricks', 'pebble pavement', 'tiling', 'dirt paths', 'road pavement', 'short vegetation', 'metal grates', 'wood panels', 'carpet', 'crosswalk', 'mat', 'stairs', 'other']

# dynamic objects: name -> (raw id, remapped id)
OBJ_CLASSES = {
    'Unlabeled': (0, 0),  # -> Unlabeled
    'Car': (1, 1),  # -> Car
    'Pedestrian': (2, 2),  # -> Pedestrian
    'Bike': (3, 3),  # -> Bike
    'Motorcycle': (4, 3),  # -> Bike
    'Golf Cart': (5, 1),  # -> Car
    'Truck': (6, 1),  # -> Car
    'Scooter': (7, 4),  # -> Scooter
    'Tree': (8, 5),  # -> Tree
    'Traffic Sign': (9, 6),  # -> Pole Sign
    'Canopy': (10, 7),  # -> Canopy
    'Traffic Light': (11, 8),  # -> Traffic Light
    'Bike Rack': (12, 9),  # -> Bike Rack
    'Bollard': (13, 10),  # -> Barrier
    'Construction Barrier': (14, 10),  # -> Barrier
    'Parking Kiosk': (15, 11),  # -> Kiosk Machine
    'Mailbox': (16, 12),  # -> Dispenser
    'Fire Hydrant': (17, 13),  # -> Fire
    'Freestanding Plant': (18, 14),  # -> Plant
    'Pole': (19, 15),  # -> Pole
    'Informational Sign': (20, 6),  # -> Pole Sign
    'Door': (21, 16),  # -> Door
    'Fence': (22, 10),  # -> Barrier
    'Railing': (23, 10),  # -> Barrier
    'Cone': (24, 17),  # -> Cone
    'Chair': (25, 18),  # -> Chair
    'Bench': (26, 19),  # -> Bench
    'Table': (27, 20),  # -> Table
    'Trash Can': (28, 21),  # -> Trash Can
    'Newspaper Dispenser': (29, 12),  # -> Dispenser
    'Room Label': (30, 22),  # -> Flat Sign
    'Stanchion': (31, 10),  # -> Barrier
    'Sanitizer Dispenser': (32, 12),  # -> Dispenser
    'Condiment Dispenser': (33, 12),  # -> Dispenser
    'Vending Machine': (34, 11),  # -> Kiosk Machine
    'Emergency Aid Kit': (35, 23),  # -> Aid Kit
    'Fire Extinguisher': (36, 13),  # -> Fire
    'Computer': (37, 24),  # -> Electronics
    'Television': (38, 24),  # -> Electronics
    'Other': (39, 25),  # -> Other
    'Horse': (40, 25),  # -> Other
    'Pickup Truck': (41, 1),  # -> Car
    'Delivery Truck': (42, 1),  # -> Car
    'Service Vehicle': (43, 1),  # -> Car
    'Utility Vehicle': (44, 1),  # -> Car
    'Fire Alarm': (45, 13),  # -> Fire
    'ATM': (46, 11),  # -> Kiosk Machine
    'Cart': (47, 26),  # -> Cart
    'Couch': (48, 27),  # -> Couch
    'Traffic Arm': (49, 28),  # -> Traffic Arm
    'Wall Sign': (50, 22),  # -> Flat Sign
    'Floor Sign': (51, 22),  # -> Flat Sign
    'Door Switch': (52, 29),  # -> Door Switch
    'Emergency Phone': (53, 30),  # -> Phone
    'Dumpster': (54, 31),  # -> Dumpster
    'Vacuum Cleaner': (55, 25),  # -> Other
    'Segway': (56, 4),  # -> Scooter
    'Bus': (57, 1),  # -> Car
    'Skateboard': (58, 4),  # -> Scooter
    'Water Fountain': (59, 25),  # -> Other
}

OBJ_REMAP_NAMES = ['Unlabeled', 'Car', 'Pedestrian', 'Bike', 'Scooter', 'Tree', 'Pole Sign', 'Canopy', 'Traffic Light', 'Bike Rack', 'Barrier', 'Kiosk Machine', 'Dispenser', 'Fire', 'Plant', 'Pole', 'Door', 'Cone', 'Chair', 'Bench', 'Table', 'Trash Can', 'Flat Sign', 'Aid Kit', 'Electronics', 'Other', 'Cart', 'Couch', 'Traffic Arm', 'Door Switch', 'Phone', 'Dumpster']


def remap_array(classes: dict) -> np.ndarray:
    """[n_raw] flat remap vector from a name->(raw, remapped) table."""
    n = len(classes)
    out = np.zeros((n,), np.int64)
    for raw, remapped in classes.values():
        out[raw] = remapped
    return out


SEM_REMAP = remap_array(SEM_CLASSES)
OBJ_REMAP = remap_array(OBJ_CLASSES)
NUM_SEM_REMAPPED = int(SEM_REMAP.max()) + 1
NUM_OBJ_REMAPPED = int(OBJ_REMAP.max()) + 1


def remap_and_sum_channels(tensor: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Fold per-class count channels by the remap: [H, W, C_raw] ->
    [H, W, C_remap], summing channels that merge (utils.py:79-103)."""
    new_c = int(remap.max()) + 1
    out = np.zeros(tensor.shape[:-1] + (new_c,), tensor.dtype)
    for src, dst in enumerate(remap):
        out[..., dst] += tensor[..., src]
    return out
