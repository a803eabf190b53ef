"""CLI replay app: ASL-format dataset -> trajectory file (port of
``scripts/vio.py``).

Port of the reference `vio` binary (src/app/vio.cpp): loads an
ASL-compatible dataset, replays messages in timestamp order through the
port's estimator, writes the trajectory. The flags and the summary line
are ``scripts/vio.py``'s, plus ``-device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions of the kernels). On CUDA a second line
gives the hand-written kernels' launches during the replay.

Usage:
  python -m xivo_tpu_torch.apps.vio -cfg cfg/tumvi_cam0.json \
      -root /data/tumvi -dataset tumvi -seq room1 -cam_id 0 -out out_state
"""
import argparse
import time

import numpy as np

from ..api import Estimator
from ..filter.config import load_json_with_comments
from ..io import IMUMsg, TrajectoryWriter, load_dataset


def _kernels():
    from ..ops import chol, hamming, imu_chain, lanes_chol, lk
    return (lanes_chol.KERNELS + lk.KERNELS + hamming.KERNELS
            + chol.KERNELS + imu_chain.KERNELS)


def replay(est, entries, max_frames=-1):
    """Feed a dataset's messages to the estimator in their order; yields
    each image message once the estimator has taken it, stops after
    `max_frames` of them (all where it is not positive) and then drains
    the reorder buffer's tail."""
    nf = 0
    for msg in entries:
        if isinstance(msg, IMUMsg):
            est.InertialMeas(msg.ts, msg.gyro, msg.accel)
            continue
        est.VisualMeas(msg.ts, msg.image())
        nf += 1
        yield msg
        if 0 < max_frames <= nf:
            break
    est.flush()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-cfg", default="cfg/tumvi_cam0.json")
    ap.add_argument("-root", required=True)
    ap.add_argument("-dataset", default="tumvi")
    ap.add_argument("-seq", default="room1")
    ap.add_argument("-cam_id", type=int, default=0)
    ap.add_argument("-out", default="out_state")
    ap.add_argument("-dtype", default="float32")
    ap.add_argument("-device", default="cuda",
                    help="the device the estimator runs on (cuda or cpu)")
    ap.add_argument("-max_frames", type=int, default=-1)
    ap.add_argument("-graphout", default="",
                    help="dump the visibility graph as Graphviz .dot "
                         "(reference -graphout, src/app/vio.cpp:27)")
    ap.add_argument("-delivery_jitter_ms", type=float, default=0.0,
                    help="perturb message DELIVERY order by up to this "
                         "many ms (timestamps untouched) — exercises "
                         "the reorder buffer the way real sensor "
                         "transport does; needs message_buffer_size>0 "
                         "in the config")
    ap.add_argument("-jitter_seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = load_json_with_comments(args.cfg)
    est = Estimator(cfg, dtype=args.dtype, device=args.device)
    entries = load_dataset(args.root, args.dataset, args.seq, args.cam_id)
    if args.delivery_jitter_ms > 0:
        rng = np.random.default_rng(args.jitter_seed)
        keys = [m.ts + rng.uniform(0, args.delivery_jitter_ms * 1e-3)
                for m in entries]
        entries = [m for _, m in sorted(zip(keys, entries),
                                        key=lambda p: p[0])]
    writer = TrajectoryWriter(args.out)
    kernels = _kernels() if est.device.type == "cuda" else ()
    for k in kernels:
        k.launches = 0

    t0 = time.time()
    nf = 0
    for msg in replay(est, entries, args.max_frames):
        nf += 1
        Rsb, Tsb = est.gsb()
        writer.add(msg.ts, Rsb, Tsb)
    wall = time.time() - t0
    writer.write()
    if args.graphout:
        from ..viz import write_graphviz
        write_graphviz(est, args.graphout)
    print(f"frames={nf} wall={wall:.1f}s fps={nf / max(wall, 1e-9):.1f} "
          f"misordered_dropped={est.num_misordered_dropped()} "
          f"td={float(est.td()):+.4f}s "
          f"-> {args.out}")
    if kernels:
        print(f"launches {({k.name: k.launches for k in kernels})}")


if __name__ == "__main__":
    main()
