"""AutoML CLI: hyper-parameter search over learner runs (counterpart of
pocketflow_tpu/automl/cli.py).

Each trial trains and evaluates a learner in-process under ``FLAGS.scope``
of its proposal, on the card unless the caller of ``main`` asks for another
device; the objective is the eval accuracy.

    python -m pocketflow_tpu_torch.automl.cli --model=convnet_at_fmnist \\
        --learner=weight-sparse --automl_nb_trials=20 --automl_algo=GP \\
        --synthetic_data --nb_epochs_rat=0.01

The search space defaults to the reference's weight-sparsification space
(``search.WS_SEARCH_SPACE``); ``--automl_space`` as
'name:type:min:max,...' overrides it.  The result file holds the best
parameters, the best objective and every trial's parameters and objective.
"""

from __future__ import annotations

import importlib
import json
import sys
import time


def parse_space(spec: str):
    from pocketflow_tpu_torch.automl.search import ParamSpec
    specs = []
    for part in spec.split(','):
        name, ptype, lo, hi = part.split(':')
        specs.append(ParamSpec(name, ptype.upper(), float(lo), float(hi)))
    return specs


def main(argv=None, device='cuda'):
    """Run the search; returns (best parameters, best objective, history,
    each trial's seconds)."""
    from pocketflow_tpu_torch.automl import search as search_lib
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core.metrics import get_logger
    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.main import MODELS, register_flags
    from pocketflow_tpu_torch.utils.path_args import apply_path_conf

    FLAGS.DEFINE_integer('automl_nb_trials', 20, 'AutoML: number of trials')
    FLAGS.DEFINE_string('automl_algo', 'GP', "AutoML: 'GP' | 'TPE' | 'random'")
    FLAGS.DEFINE_string('automl_space', '',
                        "AutoML: 'name:type:min:max,...' (default: WS space)")
    FLAGS.DEFINE_string('automl_output', './automl_result.json',
                        'AutoML: result file')
    register_flags()
    leftovers = FLAGS.parse_args(argv)
    if leftovers:
        raise SystemExit('unrecognized arguments %r (see --help)' % (leftovers,))
    if FLAGS.model not in MODELS:
        raise SystemExit('unknown model %r' % FLAGS.model)
    log = get_logger()
    # path.conf's data directories apply to the trials too
    apply_path_conf(FLAGS.model)

    specs = (parse_space(FLAGS.automl_space) if FLAGS.automl_space
             else search_lib.WS_SEARCH_SPACE)
    module = importlib.import_module(MODELS[FLAGS.model])
    seconds = []

    def objective(params):
        start = time.perf_counter()
        learner = create_learner(None, module.ModelHelper(), device=device)
        learner.train()
        metrics = learner.evaluate() if hasattr(learner, 'evaluate') else {}
        seconds.append(time.perf_counter() - start)
        log.info('trial #%d took %.1f s', len(seconds) - 1, seconds[-1])
        return float((metrics or {}).get('accuracy', 0.0))

    best, best_obj, history = search_lib.run_automl(
        objective, specs, nb_trials=FLAGS.automl_nb_trials,
        algo=FLAGS.automl_algo, seed=FLAGS.rand_seed,
        constraint_fn=search_lib.ws_constraint)
    with open(FLAGS.automl_output, 'w') as fout:
        json.dump({'best_params': best, 'best_objective': best_obj,
                   'history': [(p, o) for p, o in history]}, fout, indent=2)
    log.info('AutoML done: best=%.4f params=%s -> %s', best_obj, best, FLAGS.automl_output)
    return best, best_obj, history, seconds


if __name__ == '__main__':
    main(sys.argv[1:])
