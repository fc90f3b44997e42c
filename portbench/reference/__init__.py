"""The benchmark's yardstick for `correct`: plain numpy and PyTorch, with
nothing of the program under test imported."""
