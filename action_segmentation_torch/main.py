"""Experiment CLI, the command line of the JAX package's
``main.py`` with the same flags.

Orchestrates: data splits -> model construction -> fit loop with
per-epoch evaluation callbacks -> early stopping (best dev MoF when
supervised, best train loss otherwise) -> final per-task stats and the
summed-across-tasks / averaged-across-tasks aggregations
(main.py:486-537). Models are pickled with their args so decode runs can
reconcile command lines (main.py:445-469).

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU (there is
no device flag, as the JAX package has none):

    python -m action_segmentation_torch.main --classifier semimarkov ...

Every classifier of the JAX package runs: the semi-Markov models and
the seven baselines (``models/framewise.py``, ``models/sequential.py``).

Data parallelism over cards: one process a card, started by torchrun,
each on cuda:LOCAL_RANK, with --data_parallel (``parallel/mesh.py``):

    torchrun --nproc_per_node 4 -m action_segmentation_torch.main \
        --classifier semimarkov --data_parallel ...

Every rank returns the same stats; rank 0 alone writes the pickles,
checkpoints, prediction files and traces.
"""

import argparse
import json
import os
import pickle
import pprint
import sys
from collections import OrderedDict

import numpy as np

from action_segmentation_torch import checkpoint
from action_segmentation_torch.data.breakfast import BreakfastCorpus
from action_segmentation_torch.data.crosstask import CrosstaskCorpus
from action_segmentation_torch.models.base import add_training_args
from action_segmentation_torch.models.framewise import (
    FramewiseBaseline,
    FramewiseDiscriminative,
    FramewiseGaussianMixture,
)
from action_segmentation_torch.models.semimarkov import SemiMarkovModel
from action_segmentation_torch.models.sequential import (
    SequentialCanonicalBaseline,
    SequentialDiscriminative,
    SequentialGroundTruth,
    SequentialPredictConstraints,
)
from action_segmentation_torch.parallel.mesh import write_on_rank0
from action_segmentation_torch.utils import logger

STAT_KEYS = [
    "mof", "mof_non_bg", "step_recall_non_bg", "mean_normed_levenshtein",
    "center_step_recall_non_bg", "f1", "f1_non_bg", "pred_background",
    "iou_multi_non_bg", "predicted_label_types_per_video",
    "predicted_label_types_non_bg_per_video", "predicted_segments_per_video",
    "predicted_segments_non_bg_per_video", "multiple_gt_labels",
]
DISPLAY_STAT_KEYS = [
    "f1", "f1_non_bg", "center_step_recall_non_bg", "mean_normed_levenshtein",
    "pred_background", "iou_multi_non_bg", "predicted_label_types_per_video",
    "predicted_label_types_non_bg_per_video", "predicted_segments_per_video",
    "predicted_segments_non_bg_per_video", "mof", "mof_non_bg",
    "multiple_gt_labels",
]

CLASSIFIERS = {
    "framewise_discriminative": FramewiseDiscriminative,
    "framewise_gaussian_mixture": FramewiseGaussianMixture,
    "framewise_baseline": FramewiseBaseline,
    "semimarkov": SemiMarkovModel,
    "sequential_discriminative": SequentialDiscriminative,
    "sequential_canonical_baseline": SequentialCanonicalBaseline,
    "sequential_predict_constraints": SequentialPredictConstraints,
    "sequential_ground_truth": SequentialGroundTruth,
}


def add_serialization_args(parser):
    group = parser.add_argument_group("serialization")
    group.add_argument("--model_output_path")
    group.add_argument("--model_input_path")
    group.add_argument("--prediction_output_path")


def add_misc_args(parser):
    group = parser.add_argument_group("miscellaneous")
    group.add_argument("--compare_to_prediction_folder")
    group.add_argument("--compare_only", action="store_true")
    group.add_argument("--compare_load_splits_from_predictions", action="store_true")


def add_data_args(parser):
    group = parser.add_argument_group("data")
    group.add_argument("--dataset", choices=["crosstask", "breakfast"], default="crosstask")
    group.add_argument("--features", choices=["raw", "pca"], default="pca")
    group.add_argument("--feature_downscale", type=float, default=1.0)
    group.add_argument("--feature_permutation_seed", type=int)
    group.add_argument("--batch_size", type=int, default=5)
    group.add_argument("--remove_background", action="store_true")
    group.add_argument("--pca_components_per_group", type=int, default=100)
    group.add_argument("--pca_no_background", action="store_true")
    group.add_argument("--mix_tasks", action="store_true")
    group.add_argument("--frame_subsample", type=int, default=1)
    group.add_argument("--task_specific_steps", action="store_true")
    group.add_argument("--annotate_background_with_previous", action="store_true")
    group.add_argument("--no_merge_classes", action="store_true")
    group.add_argument("--force_optimal_assignment", action="store_true")
    group.add_argument("--no_cache_features", action="store_true")
    group.add_argument(
        "--crosstask_feature_groups",
        choices=["i3d", "resnet", "audio", "narration"],
        nargs="+",
        default=["i3d", "resnet", "audio"],
    )
    group.add_argument(
        "--crosstask_training_data",
        choices=["primary", "related"],
        nargs="+",
        default=["primary"],
    )
    group.add_argument("--crosstask_cross_validation", action="store_true")
    group.add_argument("--crosstask_cross_validation_seed", type=int)
    group.add_argument("--data_root", default="data")


def add_classifier_args(parser):
    group = parser.add_argument_group("classifier")
    group.add_argument("--classifier", choices=CLASSIFIERS.keys(), required=True)
    group.add_argument(
        "--training", choices=["supervised", "unsupervised"], default="supervised"
    )
    group.add_argument(
        "--cuda", action="store_true",
        help="accepted for command-line parity; the port runs on the card "
        "unless main() is given device='cpu'",
    )
    for name, cls in CLASSIFIERS.items():
        cls.add_args(parser)


def write_predictions(test_data, predictions_by_video, output_path):
    os.makedirs(output_path, exist_ok=True)
    for video, pred in predictions_by_video.items():
        labels = []
        task = test_data._tasks_by_video[video]
        for index in pred:
            if index in test_data._corpus._background_indices:
                label = "<BKG>"
            else:
                label = test_data._corpus.index2label[index].replace(" ", "_")
            labels.append("{}:{}".format(task, label))
        with open(os.path.join(output_path, video), "w") as f:
            f.write("### Recognized sequence: ###\n")
            f.write("\n")
            f.write("### Score: ###\n")
            f.write("\n")
            f.write("### Frame level recognition: ###\n")
            f.write(" ".join(labels))


def test(args, model, test_data, test_data_name, verbose=True, prediction_output_path=None):
    test_data.loader_workers = getattr(args, "workers", 0)
    if args.training == "supervised":
        optimal_assignment = False
    else:
        assert args.training == "unsupervised"
        optimal_assignment = not (
            args.classifier == "semimarkov" and args.sm_constrain_transitions
        )
        if "train" in args.sm_constrain_with_narration or "test" in args.sm_constrain_with_narration:
            optimal_assignment = False
    if args.force_optimal_assignment:
        optimal_assignment = True
    if model is not None:
        predictions_by_video = model.predict(test_data)
        prediction_function = lambda video: predictions_by_video[video.name]
    else:
        prediction_function = None
    if prediction_output_path is not None:
        assert model is not None
        write_on_rank0(write_predictions, test_data, predictions_by_video,
                       prediction_output_path)
    return test_data.accuracy_corpus(
        optimal_assignment,
        prediction_function,
        prefix=test_data_name,
        verbose=verbose,
        compare_to_folder=(
            args.compare_to_prediction_folder
            if not test_data_name.startswith("train")
            else None
        ),
    )


def make_model_path(path, split_name):
    if path.endswith(".pkl"):
        return path
    return os.path.join(path, "{}.pkl".format(split_name))


def train(args, train_data, dev_data, split_name, verbose=False, train_sub_data=None,
          device=None):
    for d in (train_data, dev_data, train_sub_data):
        if d is not None:
            d.loader_workers = args.workers
    model = CLASSIFIERS[args.classifier].from_args(args, train_data, device=device)

    if args.training == "supervised":
        use_labels = True
        early_stopping_on_dev = True
    else:
        use_labels = False
        early_stopping_on_dev = False

    def evaluate_on_data(data, name):
        stats_by_name = test(args, model, data, name, verbose=verbose)
        d = {}
        for key in STAT_KEYS:
            all_stats = np.array([stats[key] for stats in stats_by_name.values()])
            sum_stats = all_stats.sum(axis=0)
            d["{}_{}".format(name, key)] = float(sum_stats[0]) / sum_stats[1]
        return d

    models_by_epoch = {}
    dev_mof_by_epoch = {}
    stats_by_epoch = {}
    loss_by_epoch = {}  # train_loss forced to float ONCE per epoch

    def callback_fn(epoch, stats):
        stats_by_epoch[epoch] = stats
        if train_sub_data is not None:
            train_stats = evaluate_on_data(train_sub_data, "train_subset")
        else:
            train_stats = evaluate_on_data(train_data, "train")
        split_stats = [train_stats]
        if args.dev_decode_frequency > 0 and (
            epoch == -1 or epoch % args.dev_decode_frequency == 0
        ):
            dev_stats = evaluate_on_data(dev_data, "dev")
            split_stats.append(dev_stats)
        else:
            dev_stats = None
        log_str = "{}\tepoch {:2d}".format(split_name, epoch)
        for stat, value in stats.items():
            try:
                log_str += "\t{} {:.4f}".format(stat, float(value))
            except (TypeError, ValueError):
                log_str += "\t{} {}".format(stat, value)
        for s in split_stats:
            log_str += "\n"
            for name, val in sorted(s.items()):
                log_str += " {} {:.4f}".format(name, val)
        logger.debug(log_str)
        models_by_epoch[epoch] = pickle.dumps(model)
        if dev_stats is not None:
            dev_mof_by_epoch[epoch] = dev_stats["dev_mof"]
        # retain only pickles still selectable as best (best dev-mof /
        # best train-loss so far, computed over the FULL stat history so
        # the final selection below is unchanged)
        if "train_loss" in stats:
            loss_by_epoch[epoch] = float(stats["train_loss"])
        keep = {epoch}
        if dev_mof_by_epoch:
            keep.add(max(dev_mof_by_epoch.items(), key=lambda t: t[1])[0])
        if loss_by_epoch:
            keep.add(min(loss_by_epoch.items(), key=lambda t: t[1])[0])
        for e in [e for e in models_by_epoch if e not in keep]:
            del models_by_epoch[e]
        if args.model_output_path and epoch % 5 == 0:
            model_fname = os.path.join(
                args.model_output_path, "{}_epoch-{}.pkl".format(split_name, epoch)
            )
            logger.debug("writing model to {}".format(model_fname))
            write_on_rank0(checkpoint.save_pickle, model, model_fname)

    model.fit(train_data, use_labels=use_labels, callback_fn=callback_fn)

    # ignore stat-less callback entries (fit emits an epoch -1 callback
    # with {} after warm-start initialization) when picking the best
    # train-loss epoch
    loss_epochs = {e: s for e, s in stats_by_epoch.items() if "train_loss" in s}
    if early_stopping_on_dev and dev_mof_by_epoch:
        best_dev_epoch, best_dev_mof = max(dev_mof_by_epoch.items(), key=lambda t: t[1])
        logger.debug(
            "best dev mof {:.4f} in epoch {}".format(best_dev_mof, best_dev_epoch)
        )
        best_model = checkpoint.loads(models_by_epoch[best_dev_epoch], model.device)
    elif loss_epochs:
        best_epoch, best_train_stats = min(
            loss_epochs.items(), key=lambda t: t[1]["train_loss"]
        )
        logger.debug(
            "best train loss {:.4f} in epoch {}".format(
                float(best_train_stats["train_loss"]), best_epoch
            )
        )
        best_model = checkpoint.loads(models_by_epoch[best_epoch], model.device)
    else:
        best_model = model

    if args.model_output_path:
        model_fname = make_model_path(args.model_output_path, split_name)
        logger.debug("writing model to {}".format(model_fname))
        write_on_rank0(checkpoint.save_pickle, best_model, model_fname)

    return best_model


def make_data_splits(args):
    splits = OrderedDict()
    root = args.data_root

    if args.dataset == "crosstask":
        features_contain_background = True
        if args.features == "pca":
            max_components = 200
            assert args.pca_components_per_group <= max_components
            features_contain_background = not args.pca_no_background
            feature_root = os.path.join(
                root,
                "crosstask/crosstask_processed/crosstask_primary_pca-{}_{}-bkg_by-task".format(
                    max_components, "no" if args.pca_no_background else "with"
                ),
            )
            dimensions_per_feature_group = {
                fg: args.pca_components_per_group
                for fg in args.crosstask_feature_groups
            }
        else:
            feature_root = os.path.join(root, "crosstask/crosstask_features")
            dimensions_per_feature_group = None

        corpus = CrosstaskCorpus(
            release_root=os.path.join(root, "crosstask/crosstask_release"),
            feature_root=feature_root,
            dimensions_per_feature_group=dimensions_per_feature_group,
            features_contain_background=features_contain_background,
            task_specific_steps=args.task_specific_steps,
            annotate_background_with_previous=args.annotate_background_with_previous,
            use_secondary="related" in args.crosstask_training_data,
            constraints_root=os.path.join(root, "crosstask/crosstask_constraints"),
            load_constraints=True,
        )
        corpus._cache_features = not args.no_cache_features
        train_task_sets = args.crosstask_training_data
        test_task_sets = ["primary"]
        task_ids = sorted(
            task_id
            for task_set in sorted(set(train_task_sets) | set(test_task_sets))
            for task_id in CrosstaskCorpus.TASK_IDS_BY_SET[task_set]
        )
        if args.crosstask_cross_validation:
            if train_task_sets != ["primary"]:
                raise NotImplementedError("cross validation with related tasks")
            split_names_and_full = [
                ("cv_train_{}".format(args.crosstask_cross_validation_seed), True, train_task_sets),
                ("cv_train_{}".format(args.crosstask_cross_validation_seed), False, train_task_sets),
                ("cv_test_{}".format(args.crosstask_cross_validation_seed), True, train_task_sets),
            ]
        else:
            split_names_and_full = [
                ("train", True, train_task_sets),
                ("train", False, test_task_sets),
                ("val", True, test_task_sets),
            ]
        # a parser of the data flags alone has no misc flags
        if getattr(args, "compare_load_splits_from_predictions", False):
            assert args.compare_to_prediction_folder and args.compare_only
            with open(
                os.path.join(args.compare_to_prediction_folder, "y_pred.json"), "rb"
            ) as f:
                preds_by_task_and_video = json.load(f)
            val_videos_override = []
            for task, data in preds_by_task_and_video.items():
                val_videos_override.extend(data.keys())
            logger.debug(
                "loaded predictions for {} videos; using as the validation set".format(
                    len(val_videos_override)
                )
            )
        else:
            val_videos_override = None

        def get_splits(task_ids_subset):
            return tuple(
                corpus.get_datasplit(
                    remove_background=args.remove_background,
                    task_sets=task_sets,
                    task_ids=task_ids_subset,
                    split=split,
                    full=full,
                    subsample=args.frame_subsample,
                    feature_downscale=args.feature_downscale,
                    val_videos_override=val_videos_override,
                    feature_permutation_seed=args.feature_permutation_seed,
                )
                for split, full, task_sets in split_names_and_full
            )

        if args.mix_tasks:
            splits["all"] = get_splits(task_ids)
            train_videos = set(p[1] for p in splits["all"][0]._tasks_and_video_names)
            test_videos = set(p[1] for p in splits["all"][2]._tasks_and_video_names)
            assert not (train_videos & test_videos)
        else:
            for task_id in task_ids:
                splits["{}_val".format(task_id)] = get_splits([task_id])

    elif args.dataset == "breakfast":
        assert not args.annotate_background_with_previous
        if args.features == "pca":
            max_components = 64
            assert args.pca_components_per_group == max_components
            assert not args.pca_no_background, "not implemented"
            feature_root = os.path.join(
                root,
                "breakfast/breakfast_processed/breakfast_pca-{}_{}-bkg_by-task".format(
                    max_components, "with"
                ),
            )
        else:
            feature_root = os.path.join(root, "breakfast/reduced_fv_64")
        corpus = BreakfastCorpus(
            mapping_file=os.path.join(root, "breakfast/mapping.txt"),
            feature_root=feature_root,
            label_root=os.path.join(root, "breakfast/BreakfastII_15fps_qvga_sync"),
            task_specific_steps=args.task_specific_steps,
        )
        corpus._cache_features = True
        all_splits = list(sorted(BreakfastCorpus.DATASPLITS.keys()))
        for heldout_split in all_splits:
            # one train datasplit serves as train and train subset: both
            # are built from the same arguments and decode the same videos
            train_ds = corpus.get_datasplit(
                remove_background=args.remove_background,
                splits=[sp for sp in all_splits if sp != heldout_split],
                full=True,
                subsample=args.frame_subsample,
                feature_downscale=args.feature_downscale,
                feature_permutation_seed=args.feature_permutation_seed,
            )
            splits[heldout_split] = (
                train_ds,
                train_ds,
                corpus.get_datasplit(
                    remove_background=args.remove_background,
                    splits=[heldout_split],
                    full=True,
                    subsample=args.frame_subsample,
                    feature_downscale=args.feature_downscale,
                    feature_permutation_seed=args.feature_permutation_seed,
                ),
            )
    else:
        raise NotImplementedError("invalid dataset {}".format(args.dataset))
    return splits


def build_parser():
    parser = argparse.ArgumentParser(fromfile_prefix_chars="@")
    add_serialization_args(parser)
    add_data_args(parser)
    add_classifier_args(parser)
    add_training_args(parser)
    add_misc_args(parser)
    return parser


def main(argv=None, device=None):
    """Run the command line `argv` (None: ``sys.argv``) on `device`
    (None: the card, cuda:LOCAL_RANK under torchrun); returns the
    per-split, per-task stats. Under a process group every rank runs it
    and returns the same stats; rank 0 alone writes files."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if device is None and "LOCAL_RANK" in os.environ:
        device = "cuda:{}".format(int(os.environ["LOCAL_RANK"]))

    print(" ".join(sys.argv))
    pprint.pprint(vars(args))

    stats_by_split_and_task = {}
    stats_by_split_by_task = {}

    for split_name, (train_data, train_sub_data, test_data) in make_data_splits(args).items():
        print(split_name)
        if args.compare_only:
            assert args.compare_to_prediction_folder
            model = None
        elif args.model_input_path:
            model_path = make_model_path(args.model_input_path, split_name)
            print("loading model from {}".format(model_path))
            model = checkpoint.load_pickle(model_path, device=device)
            if vars(args) != vars(model.args):
                print("warning: command line args and serialized model args differ:")
                cmd_d, ser_d = vars(args), vars(model.args)
                for key in set(cmd_d) | set(ser_d):
                    if key in ("model_input_path", "model_output_path"):
                        continue
                    if key not in ser_d or key not in cmd_d or ser_d[key] != cmd_d[key]:
                        print(
                            "{}: {} != {}".format(
                                key, cmd_d.get(key, "<NP>"), ser_d.get(key, "<NP>")
                            )
                        )
                # the reference prints this exact (misleading) message and
                # then assigns the COMMAND-LINE args (main.py:460-461);
                # decode flows rely on CLI args winning, so both are kept
                print("setting model args to serialized args")
            model.args = args
        else:
            model = train(
                args, train_data, test_data, split_name, train_sub_data=train_sub_data,
                device=device,
            )

        print("split_name: {}".format(split_name))
        stats_by_task = test(
            args,
            model,
            test_data,
            split_name,
            prediction_output_path=args.prediction_output_path,
        )
        stats_by_split_by_task[split_name] = {}
        for task, stats in stats_by_task.items():
            stats_by_split_and_task["{}_{}".format(split_name, task)] = stats
            stats_by_split_by_task[split_name][task] = stats
        print()

    def divide(d):
        divided = {}
        for key, vals in d.items():
            assert len(vals) == 2
            divided[key] = float(vals[0]) / vals[1]
        return divided

    print()
    pprint.pprint(stats_by_split_and_task)
    print()
    pprint.pprint({k: divide(d) for k, d in stats_by_split_and_task.items()})

    summed_across_tasks = {}
    divided_averaged_across_tasks = {}
    for key in next(iter(stats_by_split_and_task.values())):
        arrs = np.array([d[key] for d in stats_by_split_and_task.values()])
        summed_across_tasks[key] = np.sum(arrs, axis=0)
        divided_averaged_across_tasks[key] = np.mean(
            [divide(d)[key] for d in stats_by_split_and_task.values()]
        )

    print()
    print("summed across tasks:")
    pprint.pprint(divide(summed_across_tasks))
    print()
    print("averaged across tasks:")
    pprint.pprint(divided_averaged_across_tasks)
    print()

    stat_dict = divided_averaged_across_tasks
    print(", ".join(STAT_KEYS))
    print(", ".join("{:.4f}".format(stat_dict[key]) for key in STAT_KEYS))
    print(", ".join(DISPLAY_STAT_KEYS))
    print(", ".join("{:.4f}".format(stat_dict[key]) for key in DISPLAY_STAT_KEYS))

    # NOTE the reference checks startswith('compare_') here (main.py:534)
    # while its corpus emits 'comparison_*' keys, so its comparison rows
    # never actually print; we match the intended behavior instead
    # (restricted to the comparison stats the corpus actually emits —
    # not every display stat has a comparison counterpart)
    compare_keys = [
        k
        for k in ("comparison_{}".format(key) for key in DISPLAY_STAT_KEYS)
        if k in stat_dict
    ]
    if compare_keys:
        print(", ".join(compare_keys))
        print(", ".join("{:.4f}".format(stat_dict[key]) for key in compare_keys))

    return stats_by_split_by_task


if __name__ == "__main__":
    main()
