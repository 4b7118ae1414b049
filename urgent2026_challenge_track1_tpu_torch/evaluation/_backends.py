"""Model loaders of the model-scored evaluation CLIs (counterpart of
``evaluation_metrics/_backends.py``).

The metrics score with pretrained models (UTMOS, SCOREQ, NISQA, mHuBERT,
wav2vec2-phoneme, RawNet3, emotion2vec, OWSM) that the reference pulls from
espnet, torch.hub and the HF hub.  Each loader tries its stack and raises
``BackendUnavailable`` where the stack or its weights are not here; the
CLIs turn that into the exit code 86 (``_shared.exit_backend_unavailable``).
Nothing is downloaded: the hub loaders read only local copies (the
torch.hub cache, the HF cache or a directory), and without one they skip.
The ``--model_path`` route (``load_torchscript``) loads a TorchScript
export onto ``--device``; a path that does not load is an error, never a
skip.  DNSMOS has its own loader (``evaluation/dnsmos.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BackendUnavailable", "ScriptedSpeech2Text", "cosine_similarity", "load_espnet_model",
           "load_hf_model", "load_torch_hub", "load_torchscript", "local_hf_dir",
           "require_local"]


class BackendUnavailable(RuntimeError):
    def __init__(self, name: str, hint: str):
        super().__init__(
            f"backend for {name} is unavailable in this environment. {hint}"
        )


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def local_hf_dir(model_id: str):
    """A local directory for ``model_id``: the path itself where it is a
    directory, else the model's snapshot in the local HF cache
    (``$HF_HUB_CACHE``, or ``$HF_HOME/hub``, or ``~/.cache/huggingface/hub``;
    the revision ``refs/main`` names, else the only one), else None.
    transformers is then handed a directory, so it never reaches for the hub."""
    import os

    if os.path.isdir(model_id):
        return model_id
    cache = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME", os.path.join(os.path.expanduser("~"), ".cache", "huggingface")),
        "hub")
    repo = os.path.join(cache, "models--" + model_id.replace("/", "--"))
    snapshots = os.path.join(repo, "snapshots")
    if not os.path.isdir(snapshots):
        return None
    revisions = sorted(os.listdir(snapshots))
    main = os.path.join(repo, "refs", "main")
    if os.path.isfile(main):
        with open(main) as f:
            revisions = [f.read().strip()]
    if len(revisions) != 1 or not os.path.isdir(os.path.join(snapshots, revisions[0])):
        return None
    return os.path.join(snapshots, revisions[0])


def require_local(model_id: str, metric: str) -> str:
    """``local_hf_dir(model_id)``, or ``BackendUnavailable`` where the model
    is not on this machine: the espnet and funasr routes run only from a
    local copy, so that none of them downloads."""
    local = local_hf_dir(model_id)
    if local is None:
        raise BackendUnavailable(metric, f"'{model_id}' is not in the local HF cache "
                                 "(pass --model_path with a TorchScript export)")
    return local


def load_hf_model(model_id: str, cls_name: str, metric: str):
    """A transformers model class and AutoProcessor pair from a local
    directory or the local HF cache (``local_hf_dir``: never the network)."""
    local = require_local(model_id, metric)
    try:
        import transformers
    except ImportError as e:
        raise BackendUnavailable(metric, "transformers is not installed") from e
    try:
        cls = getattr(transformers, cls_name)
        return cls.from_pretrained(local), transformers.AutoProcessor.from_pretrained(local)
    except Exception as e:
        raise BackendUnavailable(
            metric, f"could not load '{model_id}' from {local} ({type(e).__name__}).",
        ) from e


def load_torchscript(path: str, device="cuda"):
    """The ``--model_path`` route: a ``torch.jit`` export of the scoring
    model, loaded onto ``device`` (the card unless the caller asks for the
    CPU; without a card ``cuda`` raises).  An export that fails to load is
    the user's error, so it exits with a message and never with the skip
    code: a suite must not drop the metric silently."""
    import torch

    from urgent2026_challenge_track1_tpu_torch import resolve_device

    dev = resolve_device(device)
    try:
        return torch.jit.load(path, map_location=dev)
    except Exception as e:
        raise SystemExit(
            f"ERROR: could not torch.jit.load('{path}') "
            f"({type(e).__name__}: {e})"
        ) from e


def load_torch_hub(repo: str, entry: str, metric: str, **kwargs):
    """``entry`` of ``repo`` ("owner/name:ref") from the torch.hub cache,
    where ``torch.hub.load`` put it on a machine with a network; a repo not
    in the cache raises ``BackendUnavailable`` without reaching for one."""
    import os

    import torch

    owner_name, _, ref = repo.partition(":")
    cached = os.path.join(torch.hub.get_dir(),
                          "_".join(owner_name.split("/") + [(ref or "main").replace("/", "_")]))
    if not os.path.isdir(cached):
        raise BackendUnavailable(metric, f"'{repo}' is not in the torch.hub cache ({cached}); "
                                 "pass --model_path with a TorchScript export.")
    try:
        return torch.hub.load(cached, entry, source="local", **kwargs)
    except Exception as e:
        raise BackendUnavailable(
            metric, f"torch.hub.load of the cached '{repo}' failed ({type(e).__name__}: {e})."
        ) from e


class ScriptedSpeech2Text:
    """The ``--model_path`` route of the OWSM-backed CLIs (WER/CER, LID): a
    TorchScript export behind espnet's ``Speech2Text`` call.

    The export's contract: ``forward(wave_T: float32 Tensor, lang_sym: str,
    task_sym: str) -> str``, the transcript of one window of at most 30 s
    (it may carry ``<12.34>`` timestamps for the long-form decode; for LID
    the first whitespace token is the language tag, e.g. ``<eng>``).  The
    wave goes to ``device``.  ``beam_search.beam_size`` and ``maxlenratio``
    are accepted and not read: an export has its search built in.
    """

    def __init__(self, module, device="cuda"):
        import types

        self._m = module.to(device).eval()
        self._device = device
        self.beam_search = types.SimpleNamespace(beam_size=None)
        self.maxlenratio = None

    def __call__(self, speech, prev=None, lang_sym="<nolang>", task_sym="<asr>"):
        import torch

        x = torch.from_numpy(np.ascontiguousarray(speech, np.float32))
        with torch.no_grad():
            text = str(self._m(x.to(self._device), lang_sym, task_sym))
        # espnet's n-best entry: the text at [-2], the tokens at [1]
        return [(text, text.split() or [""], text, None)]


def load_espnet_model(tag: str, metric: str, **kwargs):
    try:
        import espnet2  # noqa: F401
    except ImportError as e:
        raise BackendUnavailable(
            metric, f"espnet is not installed (model tag: {tag})"
        ) from e
    from espnet2.bin.s2t_inference import Speech2Text

    require_local(tag, metric)
    return Speech2Text.from_pretrained(model_tag=tag, **kwargs)
