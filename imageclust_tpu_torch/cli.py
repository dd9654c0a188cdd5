"""Command-line interface of the PyTorch port.

``python -m imageclust_tpu_torch.cli run --images DIR --min 3 --max 6``
clusters a directory offline (``Pipeline.run_paths``) and prints the result
JSON; ``serve`` starts the REST service. Both take ``--device`` (default
``cuda``; ``cpu`` runs without a card). The JAX CLI's other subcommands
(train, bank, export, verify, models, bench) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".webp", ".bmp", ".ppm")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="", help="YAML config path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--model", default=None, help="embedder (resnet50)")
    p.add_argument("--labeler", default=None,
                   help="labels backend: none|fake")
    p.add_argument("--namers", default=None,
                   help="comma list of naming services (fake)")
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
    result = pipeline.run_paths(
        paths, work_dir, min_size=args.min, max_size=args.max,
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
    _add_common(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_serve = sub.add_parser("serve", help="start the REST service")
    p_serve.add_argument("--port", type=int, default=0)
    _add_common(p_serve)
    p_serve.set_defaults(fn=cmd_serve)
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
