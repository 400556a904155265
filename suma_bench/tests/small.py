"""A cell cut to a size the CPU tests hold: a 32x180 image from 32x400
rays, a 2^16-row arena, short sequences, and the mid network (on a 32x400
projection) in place of darknet53."""

SMALL_SUMA = {"data": {"height": 32, "width": 180},
              "model": {"height": 32, "width": 180},
              "map": {"surfel_capacity": 1 << 16, "active_capacity": 1 << 15,
                      "min_fresh_rows": 8640, "max_poses": 512}}
SMALL_SENSOR = {"rings": 32, "columns": 400}
MID_NETWORK = {"arch": "rangenet_darknet",
               "weights": "weights/segmenter_synth_mid.pkl",
               "data": {"height": 32, "width": 400},
               "stage_blocks": [1, 1, 2, 2, 1],
               "widths": [32, 64, 128, 192, 256, 320]}


def small(scans: int = 8, network: bool = False) -> dict:
    config = {"suma": SMALL_SUMA, "sensor": SMALL_SENSOR}
    if network:
        config["segmenter"] = MID_NETWORK
    return {"config": config,
            "traffic": {"trajectory": {"n": scans}, "warmup_scans": 3,
                        "trace_scans": [2, 4], "check_scans": 2}}
