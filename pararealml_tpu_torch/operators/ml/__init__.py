"""Machine-learning operators. Ported so far: the supervised operator
with the closed-form state-operator regressors (ROADMAP.md, Queue 1,
slice 2); the DeepONet, physics-informed and scikit-learn-backed models
are slices 3 and 4."""
