"""FLOPs of one ``fine_tune`` step counted two ways, on the CPU (a count
from shapes, not a device metric):

- XLA's ``cost_analysis()["flops"]`` of the JAX package's compiled step,
  the numerator of ``bench.py``'s MFU line;
- ``torch.utils.flop_counter.FlopCounterMode`` over the port's step, the
  numerator of ``dynamo_depth_torch.bench.throughput``'s MFU line.

    JAX_PLATFORMS=cpu python tests/compare_step_flops.py [--height 64] [--width 96] [--batch_size 3] [--port_only]

Prints one JSON line. At 64x96 the JAX step takes a minute or two to
compile; ``--port_only`` skips it (the port's count at 192x640 takes
seconds).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def port_flops(args) -> float:
    import torch

    from dynamo_depth_torch.bench.throughput import step_flops
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    torch.set_num_threads(4)
    cfg = DynamoConfig(dataset="kitti", depth_model=args.depth_model, batch_size=args.batch_size,
                       compute_dtype=args.compute_dtype, height=args.height, width=args.width, no_train_vis=True,
                       weights_init="scratch")
    trainer = Trainer(cfg, device="cpu", phase="fine_tune", steps_per_epoch=8000)
    batch = trainer.to_device(synthetic_batch(cfg, cfg.batch_size, cfg.height, cfg.width))
    return step_flops(trainer, batch, 0)


def jax_flops(args) -> float:
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _synthetic_batch
    from dynamo_depth_tpu.config import DynamoConfig
    from dynamo_depth_tpu.training.trainer import Trainer, partition_params

    cfg = DynamoConfig(dataset="kitti", depth_model=args.depth_model, batch_size=args.batch_size,
                       compute_dtype=args.compute_dtype, height=args.height, width=args.width, no_train_vis=True,
                       weights_init="scratch", num_devices=1)

    def jit_init(self):
        # The trainer's own init runs op by op (minutes on the CPU); the
        # same init under jit. The weights do not change the count.
        dummy = {("color_aug", f, 0): jnp.zeros((1, self.H, self.W, 3), jnp.float32) for f in self.cfg.frame_ids}
        return jax.jit(lambda k: self.model.init({"params": k, "droppath": k}, dummy, train=False))(
            jax.random.PRNGKey(0))

    with mock.patch.object(Trainer, "_init_variables", jit_init):
        trainer = Trainer(cfg)
    built = trainer._build_phase("fine_tune", steps_per_epoch=8000)  # as bench.py's measure
    t_params, f_params = partition_params(trainer.variables["params"], built["trainable_modules"])
    opt_state = built["tx"].init(t_params)
    batch = trainer.put_batch(_synthetic_batch(cfg, trainer.global_B, cfg.height, cfg.width))
    compiled = built["step_fn"].lower(t_params, f_params, trainer.variables.get("batch_stats", {}), opt_state, batch,
                                      jax.random.PRNGKey(0), jnp.int32(0)).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca.get("flops", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--batch_size", type=int, default=3)
    ap.add_argument("--depth_model", default="litemono")
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--port_only", action="store_true")
    args = ap.parse_args(argv)
    out = {"height": args.height, "width": args.width, "batch_size": args.batch_size,
           "depth_model": args.depth_model, "compute_dtype": args.compute_dtype,
           "port_flop_counter": port_flops(args)}
    if not args.port_only:
        out["jax_cost_analysis"] = jax_flops(args)
        out["ratio_jax_over_port"] = out["jax_cost_analysis"] / out["port_flop_counter"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
