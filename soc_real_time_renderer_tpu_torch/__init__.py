"""soc_real_time_renderer_tpu_torch — the renderer in PyTorch, with its
hot kernels written by hand in CUDA C++ for Hopper (sm_90a).

A port of ``soc_real_time_renderer_tpu`` (JAX/Pallas), which stays the
reference it is tested against.  Same layout and names, one counterpart
per module:

  config.py   static RenderConfig + per-frame ShaderGlobals (tensors)
  camera.py   perspective camera + TAA jitter; the viewer's fly camera
  scenes.py   scene presets -> BuiltScene (batch, plan, per-frame globals)
  models/     host asset pipeline: glTF loader, image decoding, terrain,
              procedural atrium, atlas packing, scene batch
  utils/      PNG (no PIL), EXR, image dumps, native helpers, matrices,
              per-pass timing (CUDA events), host spans per pass and
              copy counters (trace.py)
  tools/      the headless render CLI, the interactive viewer; a
              synthetic asset tree
  ui/         the viewer: HTTP server + render loop, scene hierarchy
              panel, settings widgets
  ops/        render passes; each ported Pallas kernel has a CUDA kernel
              (kernels/csrc) and a plain PyTorch version side by side
  graph/      frame assembly: render_frame()
  parallel/   B views of one scene in one step (a leading view axis;
              each kernel launches once for the B views)
  kernels/    nvcc build + ctypes binding of the CUDA sources
  convert.py  moves the JAX package's objects (as numpy) onto a device

Importing the package imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"
