"""The LM stack of the port: layers, MoE, Mamba2, xLSTM and the unified LM
over every family of the reference."""
