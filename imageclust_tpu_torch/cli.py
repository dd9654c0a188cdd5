"""Command-line interface of the PyTorch port.

``python -m imageclust_tpu_torch.cli run --images DIR --min 3 --max 6``
clusters a directory offline and prints the result JSON: above
``cluster.exact_limit`` images (or with ``--stream``) it streams the files
from disk through ``Pipeline.run_paths``, below it reads them as uploads
into ``Pipeline.run``. ``serve`` starts the REST service. ``export --out
F`` writes the configured ResNet50 as a gluon-named ONNX model, ``bank
--images DIR --out F`` writes a zero-shot label bank (one prototype per
subdirectory), ``train --images DIR --out CKPT`` fine-tunes the ResNet50
on labeled folders and writes an Orbax checkpoint that ``--set
embed.checkpoint_path=CKPT`` serves, ``verify --onnx F`` (or ``--clip``,
``--clip-text``) gates real weights against the reference's runtime and
prints a JSON report and a verdict, ``bench`` runs the benchmark
harness (:mod:`imageclust_tpu_torch.bench`, its flags) and prints its one
JSON line, and ``models`` lists the towers. ``run``, ``serve``, ``bank``,
``export``, ``train``, ``verify`` and ``bench`` take ``--device`` (default
``cuda``; ``cpu`` runs without a card).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

# the JAX CLI's list (imageclust_tpu/cli.py:80-86)
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".webp", ".bmp")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="", help="YAML config path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    from imageclust_tpu_torch.models import list_models

    p.add_argument("--model", default=None, choices=list_models(),
                   help="embedder tower (default resnet50)")
    p.add_argument("--labeler", default=None,
                   help="labels backend: none|fake|zero_shot|rekognition")
    p.add_argument("--namers", default=None,
                   help="comma list: fake,claude_haiku,claude_sonnet,"
                        "nova_micro,gpt-3.5-turbo,gpt-4")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="SECTION.FIELD=VALUE",
                   help="override any config knob, e.g. "
                        "--set cluster.reassign_dropped=true")
    p.add_argument("-v", "--verbose", action="store_true")


def _coerce_value(raw: str):
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if "," in raw:
        return tuple(s for s in raw.split(",") if s)
    return raw


def _build_config(args):
    from imageclust_tpu_torch.config import load_config

    overrides: dict = {}
    if args.model:
        overrides.setdefault("embed", {})["model"] = args.model
    if args.labeler is not None:
        overrides.setdefault("labels", {})["backend"] = args.labeler
    if args.namers is not None:
        overrides.setdefault("naming", {})["services"] = tuple(
            s for s in args.namers.split(",") if s
        )
    for item in getattr(args, "sets", []):
        key, sep, raw = item.partition("=")
        section, dot, field = key.partition(".")
        if not sep or not dot:
            raise SystemExit(
                f"--set expects SECTION.FIELD=VALUE, got {item!r}"
            )
        overrides.setdefault(section, {})[field] = _coerce_value(raw)
    return load_config(args.config or None, overrides)


def list_images(directory: str) -> list[str]:
    """Image files directly under ``directory``, sorted by name."""
    return [
        os.path.join(directory, name) for name in sorted(os.listdir(directory))
        if os.path.isfile(os.path.join(directory, name))
        and name.lower().endswith(_IMAGE_EXTS)
    ]


def cmd_run(args) -> int:
    from imageclust_tpu_torch.pipeline import Pipeline

    config = _build_config(args)
    if not os.path.isdir(args.images):
        print(f"error: --images {args.images} is not a directory",
              file=sys.stderr)
        return 2
    paths = list_images(args.images)
    if not paths:
        print("error: no images found", file=sys.stderr)
        return 2
    work_dir = args.out or os.path.join(args.images, ".imageclust")
    os.makedirs(work_dir, exist_ok=True)
    pipeline = Pipeline(config, device=args.device)
    if args.stream or len(paths) > config.cluster.exact_limit:
        # big directories stream from disk with bounded host memory: no
        # file, and no (N, 224, 224, 3) pixel array, is held all at once
        result = pipeline.run_paths(
            paths, work_dir, min_size=args.min, max_size=args.max,
            profile_dir=args.profile or None,
        )
    else:
        from imageclust_tpu_torch.types import UploadedImage

        uploads = []
        for path in paths:
            with open(path, "rb") as fh:
                uploads.append(UploadedImage(os.path.basename(path),
                                             fh.read()))
        result = pipeline.run(
            uploads, work_dir, min_size=args.min, max_size=args.max,
            profile_dir=args.profile or None,
        )
    print(json.dumps(result.to_dict(), indent=2))
    print(f"report: {result.html_path}", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    import dataclasses

    from imageclust_tpu_torch.service.app import run_server

    config = _build_config(args)
    if args.port:
        config = config.replace(
            service=dataclasses.replace(config.service, port=args.port)
        )
    run_server(config, device=args.device)
    return 0


def cmd_train(args) -> int:
    """Fine-tune the ResNet50 embedder on labeled image folders."""
    from imageclust_tpu_torch.models.finetune import finetune_resnet50

    _, classes, loss = finetune_resnet50(
        args.images,
        args.out,
        epochs=args.epochs,
        batch_size=args.batch,
        learning_rate=args.lr,
        onnx_out=args.onnx_out,
        init_onnx=args.init_onnx,
        device=args.device,
    )
    print(json.dumps({"checkpoint": args.out, "classes": classes,
                      "final_loss": loss}))
    return 0


def cmd_export(args) -> int:
    """Export the configured ResNet50 (its float weights, unfolded, also
    when ``embed.quantize`` is set) as a gluon-named ONNX model that
    OpenCV DNN, and so the reference itself, can load."""
    import dataclasses

    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx

    config = _build_config(args)
    if config.embed.model != "resnet50":
        print("error: ONNX export currently supports resnet50", file=sys.stderr)
        return 2
    embedder = create_embedder(
        dataclasses.replace(config.embed, quantize=""), device=args.device)
    export_resnet50_onnx(embedder.model, args.out)
    print(json.dumps({"onnx": args.out,
                      "num_classes": config.embed.num_classes}))
    return 0


def cmd_bank(args) -> int:
    """Build a zero-shot label bank: each subdirectory of --images is a
    label; its prototype is the mean embedding of the contained images."""
    import numpy as np

    from imageclust_tpu_torch.data.loader import load_image_dir
    from imageclust_tpu_torch.models import create_embedder

    config = _build_config(args)
    embedder = create_embedder(config.embed, device=args.device)
    names, vectors = [], []
    for label in sorted(os.listdir(args.images)):
        sub = os.path.join(args.images, label)
        if not os.path.isdir(sub):
            continue
        _, batch = load_image_dir(sub, size=embedder.spec.input_size)
        if len(batch) == 0:
            continue
        emb = embedder.embed(batch)
        vectors.append(emb.mean(axis=0))
        names.append(label)
    if not names:
        print("error: no label subdirectories with images found",
              file=sys.stderr)
        return 2
    np.savez(args.out, names=np.array(names), vectors=np.stack(vectors))
    print(f"wrote {len(names)} label prototypes to {args.out}")
    return 0


def cmd_verify(args) -> int:
    """Weight-parity gate for real checkpoints: ingest -> embed fixed
    images -> compare vs cv2.dnn (the reference's own runtime) ->
    cluster-assignment equality. Prints a JSON report and a PASS/FAIL
    verdict; exit code 0 (PASS), 1 (FAIL) or 2 (structural failure)."""
    from imageclust_tpu_torch.verify import run_verify

    try:
        ok, report = run_verify(
            onnx=args.onnx or None, clip=args.clip or None,
            bpe=args.bpe or None, images=args.images or None,
            sample=args.sample, clip_text=args.clip_text or None,
            quantize=args.quantize, device=args.device,
        )
    except Exception as exc:
        print(json.dumps({"ok": False, "error": str(exc)}, indent=2))
        print("VERDICT: FAIL (structural)")
        return 2
    print(json.dumps(report, indent=2))
    print(f"VERDICT: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_bench(args) -> int:
    """The benchmark harness, in this process (the JAX CLI starts the
    root bench.py, which imports JAX)."""
    from imageclust_tpu_torch import bench

    return bench.run(args)


def cmd_models(args) -> int:
    from imageclust_tpu_torch.models import list_models

    for name in list_models():
        print(name)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="imageclust-torch",
        description="image clustering on PyTorch / CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="cluster a directory of images")
    p_run.add_argument("--images", required=True)
    p_run.add_argument("--min", type=int, default=3)
    p_run.add_argument("--max", type=int, default=6)
    p_run.add_argument("--out", default="", help="work/output dir")
    p_run.add_argument("--profile", default="",
                       help="torch.profiler trace output dir")
    p_run.add_argument("--stream", action="store_true",
                       help="stream images from disk in bounded chunks "
                            "(automatic above cluster.exact_limit)")
    _add_common(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_serve = sub.add_parser("serve", help="start the REST service")
    p_serve.add_argument("--port", type=int, default=0)
    _add_common(p_serve)
    p_serve.set_defaults(fn=cmd_serve)

    p_train = sub.add_parser(
        "train", help="fine-tune the embedder on labeled image folders")
    p_train.add_argument("--images", required=True,
                         help="directory of <label>/ subdirectories")
    p_train.add_argument("--out", default="checkpoints/embedder")
    p_train.add_argument("--epochs", type=int, default=3)
    p_train.add_argument("--batch", type=int, default=64)
    p_train.add_argument("--lr", type=float, default=1e-3)
    p_train.add_argument("--onnx-out", default="",
                         help="also export the tuned model as ONNX")
    p_train.add_argument("--init-onnx", default="",
                         help="warm-start backbone from an ONNX checkpoint")
    _add_common(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_bank = sub.add_parser(
        "bank", help="build a zero-shot label bank from labeled image dirs")
    p_bank.add_argument("--images", required=True,
                        help="directory of <label>/ subdirectories")
    p_bank.add_argument("--out", default="label_bank.npz")
    _add_common(p_bank)
    p_bank.set_defaults(fn=cmd_bank)

    p_export = sub.add_parser(
        "export", help="export the embedder as an ONNX model")
    p_export.add_argument("--out", default="embedder.onnx")
    _add_common(p_export)
    p_export.set_defaults(fn=cmd_export)

    p_verify = sub.add_parser(
        "verify",
        help="weight-parity gate: compare real checkpoints against the "
             "reference's runtime (cv2.dnn) on fixed images")
    p_verify.add_argument("--onnx", default="",
                          help="resnet50-v1-7.onnx (or compatible export); "
                               "needs cv2")
    p_verify.add_argument("--clip", default="",
                          help="CLIP vision checkpoint (.pt/.bin/.npz)")
    p_verify.add_argument("--bpe", default="",
                          help="CLIP BPE merges file "
                               "(with --clip/--clip-text)")
    p_verify.add_argument("--clip-text", default="", dest="clip_text",
                          help="HF CLIPTextModel checkpoint (.pt/.bin/.npz) "
                               "for the text-fusion / zero-shot tower")
    p_verify.add_argument("--images", default="",
                          help="real images for the fixture (default: "
                               "seeded synthetics)")
    p_verify.add_argument("--sample", type=int, default=8)
    p_verify.add_argument("--quantize", choices=["", "int8"], default="",
                          help="also gate the int8 PTQ tower against the "
                               "default tower on the same ingested weights")
    p_verify.add_argument("--device", default="cuda",
                          help="torch device: cuda (default) or cpu")
    p_verify.set_defaults(fn=cmd_verify)

    from imageclust_tpu_torch import bench

    p_bench = sub.add_parser(
        "bench", help="benchmark harness: e2e (default), --e2e-stream, "
                      "--cluster-only, --embed-only, --e2e-real, --decode, "
                      "--quality")
    bench.add_arguments(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    p_models = sub.add_parser("models", help="list embedder models")
    p_models.set_defaults(fn=cmd_models)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
