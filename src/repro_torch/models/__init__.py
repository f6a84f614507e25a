"""Model layers of the port: the decoder-only LM stack for the ``attn`` and
``hymba`` mixers with the SwiGLU FFN (``layers``, ``params``,
``attention``, ``ssm``, ``blocks``, ``model``) and the host-routed MoE
expert FFN (``moe``)."""
