"""One user's text-to-image loop over the program's pipeline: whole images
back to back, each from a prompt and a noise drawn from the seed and the
image's index, tokenized, encoded, denoised and decoded by the pipeline.

Set-up: every part's weights from the seed -> the program's loaders -> the
pipeline, and one warm-up image (every shape the window uses).

Window: whole images until ``seconds`` have passed; the last one is
finished.

Check, once the program is freed:

- ``token_miss`` (exact): the ids the pipeline's tokenizers produced, every
  image, against the reference tokenizers (``models/<arch>_ref.py``).
- ``check_steps`` images drawn from the seed's first ``check_span`` of
  the window are followed through every stage against the plain float32
  references (``models/<arch>_ref.py``), each on the reference's own
  inputs where the reference makes them, the worst relative L2 gap of each:
  ``text_gap``, the T5 states and the pooled CLIP vector against the
  reference encoders' from the reference ids; ``fwd_gap``, the
  transformer's velocity at ``check_forwards`` of the image's steps drawn
  from the seed, against the reference's from the program's latent and
  sigma there and the reference's text states; ``image_gap``, the decoded
  image against the reference decoder's from the program's last latent.
- ``op_gap``: layer calls of the same images (``check_calls`` per part:
  the transformer's linears and attention, the encoders' linears, the
  decoder's convolutions; a sample of rows of each) against the plain
  float32 reference of the call on the same operands: the worst relative
  L2.
- ``update_miss`` (exact): every denoise step of every image, and the last
  into the decoder, is the nearest bf16 to x + (σ' − σ)·v. The latents
  the references start from are the program's: the start and every update
  are checked here, apart.
- ``start_gap`` (exact): each image's first latent is the benchmark's
  noise.

With ``ctx.control`` set to ``"fp8"`` the references computed one
precision below (``refops.rounded``) take the program's place in
``text_gap``, ``fwd_gap`` and ``image_gap``; the program's own readings
are kept beside them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import program
import refops
import weights
from checks import SetupClock, keep_call, op_gap, patchify, rel, update_miss


class Image:
    __slots__ = ("prompt", "noise", "fwd", "z", "ids", "ops", "in_window",
                 "timings", "text", "image", "checked")


class Session:
    def __init__(self, ctx):
        self.ctx, self.arch = ctx, ctx.arch
        self.cfg, self.traffic, self.device = ctx.config, ctx.traffic, \
            ctx.device
        self.rng = np.random.default_rng([ctx.seed, 7])
        self.images: list[Image] = []
        self.in_window = False
        self.window_images = 0
        self.check_at: set[int] = set()
        self.want: dict = {}

    def _gen(self, idx: int):
        s = np.random.SeedSequence([self.ctx.seed, idx]).generate_state(
            1, np.uint64)[0]
        return (np.random.default_rng(int(s)),
                torch.Generator(device=self.device).manual_seed(int(s)))

    def image(self):
        """One whole image; what the check needs is kept beside it."""
        tr, i = self.traffic, len(self.images)
        rng, gen = self._gen(i)
        im = Image()
        im.prompt = self.arch.prompt(rng, self.cfg, tr)
        c = self.cfg["config"]["transformer"]["in_channels"] // 4
        im.noise = torch.randn((1, tr["height"] // 8, tr["width"] // 8, c),
                               generator=gen, device=self.device,
                               dtype=torch.float32).to(torch.bfloat16)
        keep = self.in_window and self.window_images in self.check_at
        for tap in self.op_taps.values():
            tap.on = keep or tap.on
        self.fwd_tap.on = self.dec_tap.on = True
        self.text_taps["t5"].on = self.text_taps["clip"].on = keep
        self.ids = {}
        try:
            with torch.profiler.record_function("bench.generate"):
                self.pipe.generate_from_noise(
                    im.prompt, im.noise, width=tr["width"],
                    height=tr["height"], steps=tr["steps"],
                    guidance=tr["guidance"], max_t5_len=tr["text_tokens"])
        finally:
            self.fwd_tap.on = self.dec_tap.on = False
            for tap in (*self.op_taps.values(), *self.text_taps.values()):
                tap.on = False
        im.fwd = [(a[2], a[6], out) for a, out in self.fwd_tap.take()]
        (dec_args, decoded), = self.dec_tap.take()
        im.z = dec_args[2]
        im.checked = keep
        im.image = decoded if keep else None
        im.text = ({k: tap.take() for k, tap in self.text_taps.items()}
                   if keep else None)
        im.ids = self.ids
        im.ops = ([(part, kind, rec) for part, tap in self.op_taps.items()
                   for kind, _, rec in tap.take()] if keep else [])
        im.in_window = self.in_window
        im.timings = dict(self.pipe.last_timings)
        self.images.append(im)
        if self.in_window:
            self.window_images += 1


def _record_ids(s: Session, name: str, tok):
    fn = tok.encode_batch

    def encode_batch(texts, *a, **kw):
        ids, mask = fn(texts, *a, **kw)
        s.ids[name] = (np.array(ids), np.array(mask))
        return ids, mask

    tok.encode_batch = encode_batch


def setup(ctx) -> Session:
    clock = SetupClock()
    s = Session(ctx)
    s.setup_marks = clock.marks
    parts = ctx.arch.groups(ctx.config)
    s.raw = {k: weights.make_raw(g, int(np.random.SeedSequence(
        [ctx.seed, n]).generate_state(1, np.uint64)[0]), ctx.device)
        for n, (k, g) in enumerate(parts.items())}
    stored = sum(map(weights.stored_bytes, s.raw.values()))
    clock.mark("weights", f"weights drawn: {stored / 2**30:.2f} GiB stored")
    params = ctx.arch.load(s.raw, ctx.device)
    s.pipe = ctx.arch.build(params, ctx.config, ctx.device)
    del params
    if ctx.tree_hook is not None:
        ctx.tree_hook(s.pipe.model)
        ctx.tree_hook(s.pipe.t5)
    ctx.sync()
    clock.mark("load", "loaded by the program, pipeline built")
    s.keys = {}
    for part, tree in (("dit", s.pipe.model.params), ("t5", s.pipe.t5.params),
                       ("clip", s.pipe.clip_l.params),
                       ("vae", s.pipe.vae_params)):
        s.keys.update({p: (part, k) for p, k in
                       program.weight_keys(tree).items()})
    s.fwd_tap = program.ForwardTap(*ctx.arch.FORWARD, with_args=True)
    s.dec_tap = program.ForwardTap(*ctx.arch.DECODE, with_args=True)
    s.text_taps = {k: program.ForwardTap(*f)
                   for k, f in ctx.arch.ENCODE.items()}
    s.op_taps = {
        part: program.OpTap(
            mod, lambda kind, i, part=part: i in s.want.get((part, kind), ()),
            lambda name, args, kw, out: keep_call(s, name, args, kw, out))
        for part, mod in ctx.arch.OP_MODULES.items()}
    _record_ids(s, "t5", s.pipe.t5.tokenizer)
    _record_ids(s, "clip", s.pipe.clip_l.tokenizer)
    for tap in s.op_taps.values():  # the warm-up counts each part's calls
        tap.on = True
    s.image()
    ctx.sync()
    tr = ctx.traffic
    calls = {(part, kind): n for part, tap in s.op_taps.items()
             for kind, n in tap.count.items()}
    for tap in s.op_taps.values():
        tap.take()
    s.check_at = set(int(k) for k in s.rng.choice(
        tr["check_span"], size=min(tr["check_span"], tr["check_steps"]),
        replace=False))
    s.want = {pk: set(int(i) for i in s.rng.choice(
        n, size=min(n, tr["check_calls"][pk[0]].get(pk[1], 0)),
        replace=False)) for pk, n in calls.items()}
    s.check_forwards = sorted(int(k) for k in s.rng.choice(
        tr["steps"], size=min(tr["steps"], tr["check_forwards"]),
        replace=False))
    clock.mark("warmup", f"warmed up: one image; it makes {calls} layer "
               f"calls")
    return s


def window(s: Session, seconds: float, on_tick=None,
           min_ticks: int | None = None) -> dict:
    """Whole images until ``seconds`` have passed and at least
    ``min_ticks`` (by default the check's span) are done."""
    if min_ticks is None:
        min_ticks = s.traffic["check_span"]
    s.in_window = True
    first = len(s.images)
    t0 = time.perf_counter()
    while True:
        s.image()
        if on_tick is not None:
            on_tick()
        if (time.perf_counter() - t0 >= seconds
                and len(s.images) - first >= min_ticks):
            break
    s.ctx.sync()
    wall = time.perf_counter() - t0
    s.in_window = False
    done = s.images[first:]
    n, steps = len(done), s.traffic["steps"]

    def mean(*keys):
        return sum(sum(im.timings[k] for k in keys) for im in done) / n

    return {"window_s": wall, "ticks": n, "lane_steps": n * steps,
            "failed": 0, "image_s": wall / n, "lanes_per_tick": [1] * n,
            "denoise_steps_per_tick": steps,
            "text_encode_s": mean("tokenize_s", "t5_s", "clip_s"),
            "vae_decode_s": mean("vae_s")}


def _references(s: Session, W: dict, im: Image) -> dict:
    """The references' outputs of each stage of a checked image (see the
    module's doc): {"text": (T5 states, CLIP vector), "fwd": [velocity at
    each checked step], "image": [decoded image]}."""
    import flux_t2i_ref as ref

    cfg, tr, arch = s.cfg, s.traffic, s.arch
    c = cfg["config"]
    ids, mask = (torch.as_tensor(a, device=s.device)
                 for a in ref.t5_ids(im.prompt, *arch.t5_pieces(cfg),
                                     tr["text_tokens"]))
    cids = torch.as_tensor(ref.clip_ids(im.prompt, *arch.clip_vocab(cfg),
                                        c["clip"]["max_position_embeddings"]),
                           device=s.device)
    txt = ref.t5_states(W["t5"], c["t5"], ids[None], mask[None])
    y = ref.clip_pooled(W["clip"], c["clip"], cids[None])
    vs = [arch.dit_reference(W["dit"], cfg, tr, x, t, txt, y)
          for k, (x, t, _) in enumerate(im.fwd) if k in s.check_forwards]
    img = ref.vae_decode(W["vae"], c["vae"], im.z.to(torch.float32))
    return {"text": (txt, y), "fwd": vs, "image": [img]}


def check(s: Session) -> dict:
    """The numbers compared (see the module's doc). Frees the program
    first."""
    import flux_t2i_ref as ref

    tr, cfg = s.traffic, s.cfg
    s.fwd_tap.undo()
    s.dec_tap.undo()
    for tap in (*s.op_taps.values(), *s.text_taps.values()):
        tap.undo()
    s.pipe = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    pieces, scores = s.arch.t5_pieces(cfg)
    vocab, merges = s.arch.clip_vocab(cfg)
    clip_len = cfg["config"]["clip"]["max_position_embeddings"]
    W = {part: refops.Weights(raw, s.device) for part, raw in s.raw.items()}
    control = s.ctx.control == "fp8"
    tokens = start = miss = 0
    gap, n_ops = 0.0, 0
    names = ("text_gap", "fwd_gap", "image_gap")
    prog = dict.fromkeys(names, 0.0)
    low = dict.fromkeys(names, 0.0)
    n_checked = 0
    with refops.strict_f32(), torch.no_grad():
        for im in s.images:
            ids, mask = ref.t5_ids(im.prompt, pieces, scores,
                                   tr["text_tokens"])
            got_ids, got_mask = im.ids["t5"]
            tokens += int((got_ids[0] != np.array(ids)).sum()
                          + (got_mask[0] != np.array(mask)).sum())
            tokens += int((im.ids["clip"][0][0] != np.array(ref.clip_ids(
                im.prompt, vocab, merges, clip_len))).sum())
            start = max(start, float((im.fwd[0][0].float()
                                      - patchify(im.noise).float())
                                     .abs().max()))
            sig = [t for _, t, _ in im.fwd] + [torch.zeros_like(
                im.fwd[0][1])]
            outs = [x for x, _, _ in im.fwd[1:]] + [patchify(im.z)]
            for (x, _, v), s0, s1, x1 in zip(im.fwd, sig, sig[1:], outs):
                miss += update_miss(x, x1, s0, s1, v.double(),
                                    v.double().abs())
            if not (im.in_window and im.checked):
                continue
            for part, kind, rec in im.ops:
                if "key" in rec:
                    if rec["key"] is None:
                        continue  # a weight the stored files do not hold
                    part, key = rec["key"]
                    rec = dict(rec, key=key)
                gap = max(gap, op_gap(W[part], kind, rec))
                n_ops += 1
            want = _references(s, W, im)
            got = {"text": (im.text["t5"][0], im.text["clip"][0]["pooled"]),
                   "fwd": [v for k, (_, _, v) in enumerate(im.fwd)
                           if k in s.check_forwards],
                   "image": [im.image]}
            _worst(prog, got, want)
            if control:
                with refops.rounded(torch.float8_e4m3fn):
                    _worst(low, _references(s, W, im), want)
            n_checked += 1
    # nothing checked reads as a gap no limit admits (JSON has no inf)
    out = {k: v if n_checked else 1e30 for k, v in prog.items()}
    out.update(op_gap=gap if n_ops else 1e30, update_miss=miss,
               start_gap=start, token_miss=tokens, ops_checked=n_ops,
               images_checked=n_checked)
    if control:
        out["control"] = {k: v if n_checked else 1e30
                          for k, v in low.items()}
    return out


def _worst(acc: dict, got: dict, want: dict) -> None:
    """``acc`` raised to each stage's worst relative gap of ``got`` to
    ``want``."""
    for stage, outs in want.items():
        acc[stage + "_gap"] = max(acc[stage + "_gap"], *(
            rel(g, w) for g, w in zip(got[stage], outs)))
