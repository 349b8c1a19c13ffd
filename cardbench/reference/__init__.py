"""The benchmark's plain reference: float32 PyTorch written from the
published architectures, which imports nothing of the program under test.
``model`` holds the forward and the loss, ``train`` the first optimizer
steps, ``precision`` the control's lower precision."""
