"""Batch inference (port of ``raw2logit_tpu/serving.py``).

Serves raw (B, H, W) float32 mosaics -> logits (B, classes), or sigmoid
masks (B, 1, H, W) for segmentation: from modules that already hold
their weights, or from a training run of the port's CLI
(``Predictor.from_run``: the run's checkpoint files and, for a static
run, its pipeline rebuilt from the run's ``sp_*`` arguments). The CLI
serves a run on a folder of images:

    python -m raw2logit_tpu_torch.serving --experiment_name e \
        --run_name r --image_dir dngs/ [--processing_mode static] \
        [--device cpu]
"""

import argparse
import json
import os

import numpy as np
import torch

from raw2logit_tpu_torch import resolve_device, tracing
from raw2logit_tpu_torch.data.datasets import list_images_in_dir, load_image


class Predictor:
    """raw -> logits/probs pipeline on one device, in eval mode."""

    def __init__(self, processor, classifier, task="classification",
                 process_fn=None, classes=None, device=None):
        """processor: an ISP module (raw -> (rgb, stages)) or None; or
        process_fn, a plain callable raw (B, H, W) -> model-ready input.
        Both modules move to ``device`` (None means cuda, and raises when
        CUDA is missing) and switch to eval mode."""
        self.device = resolve_device(device)
        self.task = task
        self.classes = classes
        self.state_dict = None  # from_run: the run's state_dict.json
        self.processor = (processor.to(self.device).eval()
                          if processor is not None else None)
        self.classifier = classifier.to(self.device).eval()
        self.process_fn = process_fn

    @classmethod
    def from_run(cls, experiment_name, run_name, dataset_name="Microscopy",
                 network="resnet18", processing_mode="parametrized",
                 image_size=256, use_kernel=True, root="results/runs",
                 device=None, **dataset_kwargs):
        """Build from a training run's checkpoints (the run store's layout,
        ``tracking.get_model_by_name``) on ``device`` (None means cuda, and
        raises when CUDA is missing).

        ``processing_mode='parametrized'`` loads the run's processor file
        into ``ParametrizedProcessing`` (with the fused kernels unless
        ``use_kernel=False``); ``'static'`` rebuilds the static pipeline
        and the normalisation from the run's ``sp_*`` arguments. The
        dataset (a folder dataset, or a synthetic one) gives the task,
        the classes and the camera; ``dataset_kwargs`` go to
        ``get_dataset`` (``data_root`` and ``I_ratio`` for a folder). A
        segmentation dataset serves sigmoid masks from the U-Net++ that
        the JAX package builds here: a ``resnet34`` encoder, whatever
        ``network`` says. What the JAX package cannot serve raises (a run
        with another encoder, the neural and identity modes; ROADMAP
        Queue 3)."""
        from raw2logit_tpu_torch.data.datasets import (dataset_stats,
                                                       get_dataset)
        from raw2logit_tpu_torch.isp import (ParametrizedProcessing,
                                             StaticPipeline)
        from raw2logit_tpu_torch.models import UNetPlusPlus, resnet_model
        from raw2logit_tpu_torch.tracking.run import get_model_by_name
        from raw2logit_tpu_torch.training import checkpoint as ckpt

        device = resolve_device(device)
        if processing_mode not in ("parametrized", "static"):
            raise ValueError(
                f"processing_mode {processing_mode!r}: the JAX Predictor has "
                f"no branch for it and would feed the raw mosaic to the "
                f"task model, which fails (ROADMAP Queue 3)")
        state_dict, ckpts = get_model_by_name(experiment_name, run_name,
                                              root=root)
        dataset = get_dataset(dataset_name, **dataset_kwargs)
        encoder = (state_dict or {}).get("smp_encoder", "resnet34")
        if dataset.task == "segmentation" and encoder != "resnet34":
            raise ValueError(
                f"run {experiment_name}/{run_name} trained a U-Net++ on "
                f"{encoder}; the JAX Predictor always builds resnet34's and "
                f"cannot restore it (ROADMAP Queue 3)")

        processor = process_fn = None
        if processing_mode == "parametrized":
            if not ckpts["processor"]:
                raise FileNotFoundError(
                    f"run {experiment_name}/{run_name} has no processor "
                    "checkpoint: was it trained with processing_mode="
                    "'parametrized'? (pass processing_mode='static' to "
                    "serve a static-pipeline run)")
            processor = ParametrizedProcessing(
                camera_parameters=dataset.camera_parameters,
                image_size=image_size, use_kernel=use_kernel, device=device)
            ckpt.load_module(ckpts["processor"], processor)
        elif processing_mode == "static":
            # the training-time input pipeline: the static ISP and
            # (x - mean) / std, as the CLI's static mode runs it
            sd = state_dict or {}
            pipe = StaticPipeline(
                camera_parameters=dataset.camera_parameters,
                debayer=sd.get("sp_debayer", "bilinear"),
                sharpening=sd.get("sp_sharpening", "sharpening_filter"),
                denoising=sd.get("sp_denoising", "gaussian_denoising"))
            stats = dataset_stats(dataset_name)
            mean, std = (torch.tensor(stats[k], dtype=torch.float32,
                                      device=device).reshape(3, 1, 1)
                         for k in ("mean", "std"))

            def process_fn(raw):
                return (pipe(raw) - mean) / std

        if dataset.task == "classification":
            classifier = resnet_model(network,
                                      fc_out_features=len(dataset.classes),
                                      device=device)
        else:
            classifier = UNetPlusPlus(encoder_depth=5,
                                      decoder_channels=(256, 128, 64, 32, 16),
                                      classes=1, device=device)
        ckpt.load_module(ckpts["classifier"], classifier)
        pred = cls(processor, classifier, task=dataset.task,
                   process_fn=process_fn,
                   classes=getattr(dataset, "classes", None), device=device)
        pred.state_dict = state_dict
        return pred

    def __call__(self, raw_batch):
        """raw (B, H, W) numpy array or tensor -> logits (classification)
        or sigmoid masks (segmentation), a tensor on the device.

        A call runs inside the span ``r2l.serve``, its stages inside
        ``r2l.serve.copy_in`` (to a float32 tensor on the device),
        ``.process`` (the ISP or ``process_fn``) and ``.model`` (the task
        model, and the sigmoid for segmentation)."""
        with tracing.span("r2l.serve"):
            with tracing.span("r2l.serve.copy_in"):
                if not torch.is_tensor(raw_batch):
                    raw_batch = torch.as_tensor(np.asarray(raw_batch,
                                                           np.float32))
                raw = raw_batch.to(self.device, torch.float32).contiguous()
            with torch.inference_mode():
                with tracing.span("r2l.serve.process"):
                    if self.process_fn is not None:
                        rgb = self.process_fn(raw)
                    elif self.processor is not None:
                        rgb, _ = self.processor(raw)
                    else:
                        rgb = raw
                with tracing.span("r2l.serve.model"):
                    out = self.classifier(rgb)
                    if self.task == "segmentation":
                        out = torch.sigmoid(out)
            return out

    def predict_dir(self, image_dir, batch_size=32, bits=16,
                    out_path=None):
        """Run every image in a directory; write a predictions JSONL and
        return its path."""
        paths = list_images_in_dir(image_dir)
        out_path = out_path or os.path.join("results", "predictions.jsonl")
        if os.path.dirname(out_path):  # bare filename -> cwd
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as fh:
            for i in range(0, len(paths), batch_size):
                chunk = paths[i:i + batch_size]
                raws = np.stack([load_image(p) / (2 ** bits - 1)
                                 for p in chunk])
                out = self(raws).cpu().numpy()
                for p, o in zip(chunk, out):
                    if self.task == "classification":
                        pred = int(np.argmax(o))
                        rec = {"file": p, "pred": pred,
                               "class": (self.classes[pred]
                                         if self.classes else pred),
                               "logits": [float(x) for x in o]}
                    else:
                        rec = {"file": p,
                               "mask_mean": float(o.mean()),
                               "mask_pixels": int((o > 0.5).sum())}
                    fh.write(json.dumps(rec) + "\n")
        return out_path


def main(argv=None):
    """Serve a training run on a folder of images; writes the predictions
    JSONL and returns its path."""
    p = argparse.ArgumentParser(description="batch inference")
    p.add_argument("--experiment_name", required=True)
    p.add_argument("--run_name", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--dataset", default="Microscopy")
    p.add_argument("--data_root", default="data",
                   help="the folder datasets' root")
    p.add_argument("--network", default="resnet18")
    p.add_argument("--processing_mode", default="parametrized")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where to serve: cuda (the default; raises without "
                        "CUDA) or cpu")
    args = p.parse_args(argv)
    folder = ({} if args.dataset.startswith("Synthetic")
              else {"data_root": args.data_root})
    pred = Predictor.from_run(
        args.experiment_name, args.run_name, dataset_name=args.dataset,
        network=args.network, processing_mode=args.processing_mode,
        device=None if args.device == "cuda" else args.device, **folder)
    out = pred.predict_dir(args.image_dir, batch_size=args.batch_size,
                           out_path=args.out)
    print(f"predictions -> {out}")
    return out


if __name__ == "__main__":
    main()
