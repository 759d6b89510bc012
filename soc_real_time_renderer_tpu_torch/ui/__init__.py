"""The interactive viewer: settings widget schemas (``widgets``), the
scene hierarchy panel (``scene_panel``) and the HTTP server with its
render loop (``server``); counterpart of the JAX package's ``ui/``, the
replacement of the reference's ImGui/GLFW editor stack."""
