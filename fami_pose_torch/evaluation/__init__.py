from .evaluate import evaluate, evaluate_ap_files
from .annolist_writer import convert_data_to_annorect_struct, write_video_annolists
