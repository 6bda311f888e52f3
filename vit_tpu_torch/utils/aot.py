"""Ahead-of-time export: the serving program serialized to bytes (port of
``vit_tpu/utils/aot.py``).

``torch.export`` traces the whole serving program, uint8 images ->
on-device preprocess -> model -> logits, with the weights baked in, and
``torch.export.save`` serializes it. A serving host loads and runs it
without the model code: it needs ``torch`` and the port's operator
registrations only (``vit_tpu_torch.ops``, imported here). Each kernel of
the port is a ``torch.library`` operator (``vit_tpu_torch::<name>``), so
the exported graph holds ``aten`` operators and the port's operators and
nothing else: a program exported on the card launches the hand-written
kernels, one exported on the CPU runs their twins. A program runs on the
device it was exported on; it never moves to another.

Shapes are static: the kernels' plans and the buckets of
``InferencePipeline`` are per batch size, so ``export_serving`` writes one
program per batch bucket into one zip artifact, and ``ExportedServing``
pads a batch to the smallest bucket that holds it. The buckets' programs
share one copy of the weights: each program is saved with stand-ins of
no size in their place, and the weights once, beside the programs;
loading binds them back into each program. An artifact is made and loaded
by one PyTorch version: ``torch.export`` does not promise to load one
across versions.
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.export import ExportedProgram, ExportGraphSignature
from torch.export.graph_signature import InputKind

import vit_tpu_torch.ops  # noqa: F401  (registers the vit_tpu_torch:: operators)
from vit_tpu_torch.pipeline import preprocess

_MAGIC = "vit_tpu_torch_aot_v1"
_NOT_AN_ARTIFACT = "not a vit_tpu_torch AOT serving artifact"


class _Call(nn.Module):
    """A function as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _stand_in(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor of ``t``'s shape and dtype over one element (stride 0):
    it serializes to one element (a CUDA one would be copied to the host in
    full on the way)."""
    s = torch.zeros((), dtype=t.dtype).expand(t.shape)
    return nn.Parameter(s, requires_grad=False) if isinstance(t, nn.Parameter) else s


def _without_unread_state(program: ExportedProgram, stand_ins=frozenset()) -> ExportedProgram:
    """``program`` without the parameters, buffers and constants its graph
    never reads (``torch.export`` lifts every tensor of the module, and a
    ``QuantViT`` keeps its int8 codes in two layouts, of which one mode
    reads one), with ``_stand_in``s in place of the tensors named in
    ``stand_ins``."""
    gm, signature = program.graph_module, program.graph_signature
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    kept = []
    for node, spec in zip(placeholders, signature.input_specs):
        if node.users or spec.kind == InputKind.USER_INPUT:
            kept.append(spec)
        else:
            gm.graph.erase_node(node)
    gm.recompile()
    targets = {spec.target for spec in kept}
    kept_state = lambda d: {k: _stand_in(v) if k in stand_ins else v for k, v in d.items()
                            if k in targets}
    return ExportedProgram(
        root=gm, graph=gm.graph,
        graph_signature=ExportGraphSignature(input_specs=kept,
                                             output_specs=signature.output_specs),
        state_dict=kept_state(program.state_dict),
        range_constraints=program.range_constraints,
        module_call_graph=program.module_call_graph,
        example_inputs=program.example_inputs,
        constants=kept_state(program.constants),
        verifiers=program.verifiers,
    )


def _module_tensors(module: nn.Module, program: ExportedProgram) -> Dict[str, torch.Tensor]:
    """The tensors of ``program``'s state and constants that are
    ``module``'s own (its parameters, buffers and tensor attributes, by
    name), as opposed to those the trace made."""
    own = {}
    for name, t in [*program.state_dict.items(), *program.constants.items()]:
        prefix, _, leaf = name.rpartition(".")
        try:
            owner = module.get_submodule(prefix)
        except AttributeError:
            continue
        if getattr(owner, leaf, None) is t:
            own[name] = t
    return own


def _bind(module: nn.Module, name: str, t: torch.Tensor) -> None:
    """Put ``t`` in the place of ``module``'s tensor ``name``."""
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix)
    setattr(owner, leaf, nn.Parameter(t, requires_grad=False) if leaf in owner._parameters else t)


def _export(module: nn.Module, example_args: tuple) -> ExportedProgram:
    with torch.no_grad():
        return torch.export.export(module, example_args, strict=False)


def _save(program: ExportedProgram) -> bytes:
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # torch.export.save warns of a tensor that does not cover its
        # storage, as a stand-in does, and saves the storage: one element
        warnings.filterwarnings("ignore", "No complete tensor found in the group")
        torch.export.save(program, buf)
    return buf.getvalue()


def export_forward(fn: Callable, *example_args) -> bytes:
    """Serialize ``torch.export.export`` of ``fn`` (a module, or a function,
    which is wrapped in one) traced at ``example_args`` under
    ``torch.no_grad()``, with ``torch.export.save``; the state the graph
    never reads is left out."""
    module = fn if isinstance(fn, nn.Module) else _Call(fn)
    return _save(_without_unread_state(_export(module, tuple(example_args))))


def load_forward(blob: bytes) -> Callable:
    """Deserialize an ``export_forward`` artifact into a callable module."""
    return torch.export.load(io.BytesIO(blob)).module()


class _Serving(nn.Module):
    """uint8 ``[b, h, w, 3]`` -> ``preprocess`` -> the model (or
    ``apply_fn(model, x)``) -> logits; the first element of a tuple output
    (LeViT's ``(logits, distill)``)."""

    def __init__(self, model: nn.Module, image_size: int, dtype, apply_fn: Optional[Callable]):
        super().__init__()
        self.model = model
        self.image_size, self.dtype, self.apply_fn = image_size, dtype, apply_fn

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        x = preprocess(raw, image_size=self.image_size, dtype=self.dtype)
        out = self.model(x) if self.apply_fn is None else self.apply_fn(self.model, x)
        return out[0] if isinstance(out, tuple) else out


def export_serving(
    model: nn.Module,
    *,
    image_size: int,
    batch_buckets: Sequence[int] = (1, 8, 64),
    decode_size: int = 256,
    dtype=torch.bfloat16,
    apply_fn: Optional[Callable] = None,
) -> bytes:
    """Package the serving path (uint8 ``[b, decode_size, decode_size, 3]``
    -> preprocess -> logits) with the weights baked in, one program per
    batch bucket, as one artifact, on the device of the model's parameters.

    ``apply_fn(model, x)`` overrides the forward, e.g. ``lambda m, x:
    quantized_apply(m, qstate, x)`` or ``simple_vit_apply_w8a8``. A
    ``QuantViT`` in mode ``"auto"`` gets, in each bucket's program, the mode
    ``resolve_quant_mode`` gives that batch size."""
    serving = _Serving(model.eval(), image_size, dtype, apply_fn)
    device = next(model.parameters()).device
    weights: Dict[str, torch.Tensor] = {}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("MAGIC", _MAGIC)
        z.writestr("buckets", ",".join(str(b) for b in sorted(batch_buckets)))
        z.writestr("device", str(device))
        for b in sorted(batch_buckets):
            raw = torch.zeros((b, decode_size, decode_size, 3), dtype=torch.uint8, device=device)
            program = _without_unread_state(_export(serving, (raw,)))
            own = _module_tensors(serving, program)
            weights.update(own)
            # the graph and the stand-ins, which deflate well; the weights stay stored
            z.writestr(f"program_{b}", _save(_without_unread_state(program, set(own))),
                       compress_type=zipfile.ZIP_DEFLATED)
            z.writestr(f"weights_of_{b}", json.dumps(sorted(own)))
        state = io.BytesIO()
        torch.save({k: v.detach() for k, v in weights.items()}, state)
        z.writestr("weights", state.getvalue())
    return buf.getvalue()


class ExportedServing:
    """Load an ``export_serving`` artifact and serve it.

    Pads a ragged batch with zero images up to the smallest bucket that
    holds it, runs batches past the largest bucket in chunks of it, and
    slices the logits back: ``InferencePipeline``'s static-shape policy, run
    by the exported programs alone, under ``torch.inference_mode()``."""

    def __init__(self, blob: bytes):
        try:
            z = zipfile.ZipFile(io.BytesIO(blob))
            magic = z.read("MAGIC").decode()
        except (zipfile.BadZipFile, KeyError) as e:
            raise ValueError(_NOT_AN_ARTIFACT) from e
        if magic != _MAGIC:
            raise ValueError(_NOT_AN_ARTIFACT)
        self.buckets = [int(s) for s in z.read("buckets").decode().split(",")]
        self.device = torch.device(z.read("device").decode())
        weights = torch.load(io.BytesIO(z.read("weights")), map_location=self.device,
                             weights_only=True)
        self._programs: Dict[int, Callable] = {}
        for b in self.buckets:
            program = load_forward(z.read(f"program_{b}"))
            for name in json.loads(z.read(f"weights_of_{b}")):
                _bind(program, name, weights[name])  # shared, in place of a stand-in
            self._programs[b] = program

    def run(self, raw: torch.Tensor) -> torch.Tensor:
        """Logits of uint8 images ``raw`` ``[n, h, w, 3]`` on ``self.device``,
        left there: padded, chunked and sliced as ``__call__`` says."""
        n = raw.shape[0]
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:  # larger than the largest bucket: chunk it
            big = self.buckets[-1]
            return torch.cat([self.run(raw[i:i + big]) for i in range(0, n, big)])
        if n < bucket:
            raw = torch.cat([raw, raw.new_zeros((bucket - n,) + tuple(raw.shape[1:]))])
        with torch.inference_mode():
            return self._programs[bucket](raw)[:n]

    def __call__(self, raw_images: np.ndarray) -> np.ndarray:
        """Classify a host batch of uint8 images of any size; returns fp32
        numpy logits."""
        raw = torch.from_numpy(np.ascontiguousarray(raw_images)).to(self.device)
        return self.run(raw).float().cpu().numpy()
