#!/usr/bin/env python3
"""How far Mask2Former's attention masks in the program (bf16) agree with
the plain reference's (f32), decoder layer by decoder layer:

    python3 scripts/m2f_mask_agreement.py --seeds 1,2,3 [--workload CELL]

For each seed: the benchmark's weights and first pool batch of the cell
(``portbench/``; the first ``reference_rows`` rows, corrupted with the
cell's draws and prepared by the reference), the port's model in bf16 and
the reference in f32 (TF32 off) on the same prepared images. Prints one
JSON line a seed: for each of the decoder's layers the share of mask
entries (query × key) that one side blocks and the other lets through
(the hard ``sigmoid < 0.5`` threshold flips where bf16 moves a mask logit
across 0), and the semantic scores' relative L2 distance. Runs on the card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch


def recorder(obj, attr, pick, into):
    """Wraps ``obj.attr`` so that ``pick(result)`` is kept in ``into``."""
    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        kept = pick(out)
        if kept is not None:
            into.append(kept)
        return out
    setattr(obj, attr, wrapped)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--seeds', required=True)
    p.add_argument('--workload', default='sweep-m2fr50-cityscapes')
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench import harness
    from portbench.common import port, weights
    from portbench.common import traffic as gen
    from portbench.drivers.sweep import no_tf32
    from portbench.reference import model as ref_model
    from portbench.reference.data import prepare_batch
    c = harness.cell(args.workload, harness.manifest())
    config, t = c['config'], dict(c['traffic'])
    t.update(pool=1, batch=t['reference_rows'])
    dev = torch.device('cuda')
    for seed in (int(s) for s in args.seeds.split(',')):
        pool = gen.host_pool(seed, t, config['model']['num_classes'],
                             pin=False)
        draws = gen.corruption_draws(seed, pool, dev)
        shapes = weights.shapes_of(port.skeleton(config))
        state = weights.make_state(shapes, seed, dev, torch.bfloat16)
        program = port.build(config, dict(state))
        reference = ref_model.build(config, state, dev)
        del state
        keeps, blocked = [], []
        recorder(program.predictor, 'predict_masks', lambda o: o[1], keeps)
        recorder(reference.predictor, 'heads', lambda o: o[1], blocked)
        b = pool[0]
        with torch.inference_mode(), no_tf32():
            prep = prepare_batch(b['image'].to(dev), b['label'].to(dev),
                                 b['weather_id'].to(dev), draws[0])
            want = reference(prep['image'])['segmentation'].double()
            got = program(prep['image'].to(torch.bfloat16))[
                'segmentation'].double()
        flips = [float((k.squeeze(1) == bl).float().mean())
                 for k, bl in zip(keeps, blocked)]
        print(json.dumps({
            'seed': seed, 'size': [t['height'], t['width']],
            'rows': t['reference_rows'], 'mask_flip_share': flips,
            'blocked_share': [float(bl.float().mean()) for bl in blocked],
            'scores_rel': float((got - want).norm() / want.norm()),
            'device': torch.cuda.get_device_name(0)}), flush=True)
        del program, reference
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
