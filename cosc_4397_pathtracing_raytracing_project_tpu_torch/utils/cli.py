"""Command-line entry point.

Port of the JAX package's ``utils/cli.py``: the same flags, defaults and
paths, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions). The JAX package takes its platform from the environment;
this package names its device, and without a card the default fails with the
Renderer's ``RuntimeError`` rather than render on the CPU.

The reference takes exactly one argument — the scene file (`main.cpp:37-42`)
— runs to the scene's ITERATIONS count while printing the metrics block each
iteration (`pathtrace.cu:632-646`), and saves
``<FILE>.<timestamp>.<N>samp.png`` at the end. ``main`` reproduces that as
the default headless mode; ``--serve`` opens the interactive preview instead
(the GLFW window analog), and the extra flags expose what the reference
hard-codes.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cosc_4397_pathtracing_raytracing_project_tpu_torch",
        description="Monte Carlo path tracer (PyTorch/CUDA port)",
    )
    p.add_argument("scene", help="scene file (scenes/*.txt format)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the scene's ITERATIONS")
    p.add_argument("--model", default="auto",
                   help="renderer model: auto|naive|shared|bvh|megakernel|wavefront")
    p.add_argument("--estimator", default="light_only",
                   choices=["light_only", "throughput"],
                   help="light_only = physically correct; throughput = "
                        "reference-code finalGather parity")
    p.add_argument("--sky", type=float, default=0.0,
                   help="environment sky strength (light_only mode)")
    p.add_argument("--antialias", action="store_true",
                   help="sub-pixel jitter (the reference has none)")
    p.add_argument("--refraction", default="auto",
                   choices=["auto", "on", "off"],
                   help="dielectric refraction via REFRIOR (extension; the "
                        "reference parses but never refracts). auto = on "
                        "when any material has REFR>0 and REFRIOR>0")
    p.add_argument("--nee", action="store_true",
                   help="direct light sampling + MIS (extension; the working "
                        "version of the reference's dead dev_lightPositions). "
                        "light_only estimator; in-kernel on the megakernel, "
                        "SoA fast path or wavefront elsewhere")
    p.add_argument("--envmap", default=None,
                   help="HDR environment map path (extension; equivalent to "
                        "an ENVIRONMENT block in the scene file — replaces "
                        "the hard-coded gradient sky with an equirect "
                        "Radiance HDR light; combine with --nee for "
                        "importance-sampled IBL)")
    p.add_argument("--env-strength", type=float, default=None,
                   help="environment radiance multiplier (default 1, or the "
                        "scene's STRENGTH line)")
    p.add_argument("--env-mode", default="exact",
                   choices=["exact", "split"],
                   help="environment evaluation: exact = unbiased HDR "
                        "lookups + importance sampling (the fast pipeline); "
                        "split = megakernel sun/sky decomposition (delta "
                        "suns + SH-9 residual + exact composited "
                        "background) — approximate but megakernel-fast")
    p.add_argument("--sampler", default="independent",
                   choices=["independent", "sobol"],
                   help="sample generator (extension; the reference only "
                        "has independent per-pixel engines). sobol = "
                        "per-pixel digitally-shifted (0,2)-sequences on "
                        "the first-vertex dimensions: same mean, lower "
                        "variance at equal spp")
    p.add_argument("--ld-depths", type=int, default=2,
                   help="with --sampler sobol: how many leading bounce "
                        "depths draw from the LD lattice (padded Sobol, "
                        "fresh digital shifts per depth); deeper bounces "
                        "use the hash streams")
    p.add_argument("--denoise", action="store_true",
                   help="feature-guided A-Trous denoise of the saved image "
                        "(extension; AOV pass + edge-avoiding wavelet "
                        "filter — see render/denoise.py). Buys several dB "
                        "at low sample counts; a converged render passes "
                        "through nearly unchanged")
    p.add_argument("--adaptive", action="store_true",
                   help="variance-guided adaptive sampling (extension; see "
                        "render/adaptive.py): uniform warmup, then "
                        "refinement rounds that spend the remaining sample "
                        "budget on the noisiest image tiles. Megakernel "
                        "pipeline (analytic scenes); ITERATIONS becomes the "
                        "average spp budget")
    p.add_argument("--adaptive-frac", type=float, default=0.25,
                   help="with --adaptive: fraction of tiles refined per "
                        "round (default 0.25)")
    p.add_argument("--adaptive-round", type=int, default=32,
                   help="with --adaptive: samples per refined tile per "
                        "round (default 32)")
    p.add_argument("--early-exit", action="store_true",
                   help="megakernel: skip bounces once a whole tile's lanes "
                        "terminate. Wins on OPEN scenes (rays escape), "
                        "costs time on closed boxes")
    p.add_argument("--aperture", type=float, default=None,
                   help="thin-lens depth of field: lens radius in world "
                        "units (extension; overrides the scene's APERTURE "
                        "line, 0 = pinhole)")
    p.add_argument("--focal", type=float, default=None,
                   help="focal-plane distance along the view axis "
                        "(overrides the scene's FOCAL line; <= 0 = "
                        "auto-focus on LOOKAT)")
    p.add_argument("--depth", type=int, default=None, help="override DEPTH")
    p.add_argument("--chunk", type=int, default=25,
                   help="samples per device launch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None, help="output PNG path")
    p.add_argument("--hdr", action="store_true", help="also save Radiance .hdr")
    p.add_argument("--checkpoint", default=None,
                   help="write a checkpoint here at the end")
    p.add_argument("--resume", default=None, help="resume from a checkpoint")
    p.add_argument("--serve", action="store_true",
                   help="interactive web preview instead of headless render")
    p.add_argument("--port", type=int, default=8634)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on: cuda (the CUDA kernels; "
                        "fails without a card) or cpu (their plain PyTorch "
                        "versions)")
    p.add_argument("--metrics-every", type=int, default=1,
                   help="print the metrics block every N iterations, at "
                        "device-launch granularity (default 1 = every "
                        "launch, the reference's per-iteration block; "
                        "0 = end only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..render.engine import RenderConfig, Renderer
    from ..models.registry import make_renderer
    from ..scene.parser import load_scene_desc

    desc = load_scene_desc(args.scene)
    if args.envmap is not None:
        from ..io.png import read_hdr

        desc.env_image = read_hdr(args.envmap)
    if args.env_strength is not None:
        if desc.env_image is None:
            print("error: --env-strength needs --envmap or an ENVIRONMENT "
                  "block", file=sys.stderr)
            return 2
        desc.env_strength = float(args.env_strength)
    if args.aperture is not None:
        desc.camera.aperture = float(args.aperture)
    if args.focal is not None:
        desc.camera.focal = float(args.focal)
    if args.refraction == "auto":
        # never in throughput mode: that is the reference-code parity
        # estimator, and the reference parses REFRIOR but never refracts —
        # auto-enabling would silently diverge from upstream renders
        refraction = args.estimator != "throughput" and any(
            r > 0 and i > 0 for r, i in zip(desc.refractive, desc.ior)
        )
        if refraction and not args.quiet:
            print("refraction: enabled (REFRIOR materials present; "
                  "--refraction off to disable)")
    else:
        refraction = args.refraction == "on"
    config = RenderConfig(
        trace_depth=args.depth if args.depth is not None else desc.trace_depth,
        antialias=args.antialias,
        gather_mode=args.estimator,
        sky_strength=args.sky,
        samples_per_launch=args.chunk,
        enable_refraction=refraction,
        nee=args.nee,
        early_exit=args.early_exit,
        sampler=args.sampler,
        ld_depths=max(1, args.ld_depths),
        env_mode=args.env_mode,
    )
    if args.nee and args.estimator == "throughput":
        print("error: --nee needs the light_only estimator", file=sys.stderr)
        return 2
    # nee runs on the reference wavefront, the SoA fast path ('shared'/
    # 'naive'/'bvh'), and in-kernel on the megakernel; the custom
    # wavefront-compaction step doesn't carry it
    if args.nee and args.model == "wavefront":
        print("error: --nee is not supported with --model wavefront",
              file=sys.stderr)
        return 2
    if args.adaptive:
        if args.model != "auto":
            print("error: --adaptive runs its own (megakernel) pipeline; "
                  "drop --model", file=sys.stderr)
            return 2
        if args.serve:
            print("error: --adaptive is headless-only (no --serve)",
                  file=sys.stderr)
            return 2
        from ..render.adaptive import AdaptiveRenderer

        r = AdaptiveRenderer(desc, config, seed=args.seed, device=args.device)
        if args.resume:
            r.load_checkpoint(args.resume)
            if not args.quiet:
                print(f"resumed at {r.avg_spp:.1f} avg spp")
        target = args.iterations if args.iterations is not None else desc.iterations
        r.render(
            avg_spp=target,
            round_spp=args.adaptive_round,
            frac=args.adaptive_frac,
            progress=not args.quiet,
        )
        r.sync()
        if not args.quiet:
            spp = r.spp_map()
            print(
                f"adaptive: {r.avg_spp:.1f} avg spp "
                f"(min {spp.min()}, max {spp.max()}) — "
                f"{r.samples_per_second / 1e6:.1f} M samples/s"
            )
        if args.checkpoint:
            r.save_checkpoint(args.checkpoint)
            if not args.quiet:
                print(f"Checkpoint at {args.checkpoint}")
        out = r.save_png(args.output, denoise=args.denoise)
        if not args.quiet:
            print(f"Saved {out}.")
        return 0

    if args.model == "auto":
        renderer = Renderer(desc, config, seed=args.seed, device=args.device)
    else:
        renderer = make_renderer(args.model, desc, config, seed=args.seed,
                                 device=args.device)

    if args.resume:
        renderer.load_checkpoint(args.resume)
        if not args.quiet:
            print(f"resumed at iteration {renderer.iteration}")

    if args.serve:
        from ..viewer.server import PreviewServer

        PreviewServer(renderer, lookat=desc.camera.lookat, port=args.port).start()
        return 0

    target = args.iterations if args.iterations is not None else desc.iterations
    every = args.metrics_every
    # metrics on → reference-parity PSNR: baseline = a true iteration-10
    # frame even when --chunk crosses it (pathtrace.cu:184-191)
    renderer.psnr_snapshot = bool(every)
    while renderer.iteration < target:
        n = min(args.chunk, target - renderer.iteration)
        renderer.step(n, sync=bool(every))
        if every and (renderer.iteration % every == 0 or renderer.iteration >= target):
            renderer.metrics.update_psnr(renderer.state.accum, renderer.iteration)
            if not args.quiet:
                print(f"-- iteration {renderer.iteration}/{target} --")
                print(renderer.metrics.summary())
    renderer.sync()
    renderer.metrics.update_psnr(renderer.state.accum, renderer.iteration)

    if not args.quiet:
        print(renderer.metrics.summary())
    out = renderer.save_png(args.output, denoise=args.denoise)
    if not args.quiet:
        print(f"Saved {out}.")
    if args.hdr:
        from ..io.png import write_hdr

        hdr_path = out[:-4] if out.endswith(".png") else out
        write_hdr(hdr_path, renderer.linear_image()[:, ::-1, :])
        if not args.quiet:
            print(f"Saved {hdr_path}.hdr.")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"Checkpoint at {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
